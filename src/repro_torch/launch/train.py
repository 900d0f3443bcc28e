"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> ...``

The production loop's shape on one device: the counter-based data
pipeline, atomic keep-N checkpointing with restore-on-start (a restarted
job resumes from the latest step by itself), heartbeat and straggler
detection, gradient accumulation. It runs on ``cuda`` unless asked for
the CPU (``--device cpu``). The reference's mesh (``--mesh pod``, sharded
state) waits for the distributed item (ROADMAP.md A.7): ``--mesh none``
and ``debug`` both mean one device here, and ``train_loop`` takes
``mesh=None`` in the reference's position.

Reduced configs by default (``--layers`` / ``--d-model`` / ``--heads`` /
``--vocab``, in f32); ``--full-config`` trains the assigned config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model_zoo
from repro_torch.runtime.fault_tolerance import (Heartbeat, SimulatedFailure,
                                                 StragglerDetector)
from repro_torch.train import train_state as ts
from repro_torch.train.optimizer import AdamWConfig


def reduce_config(cfg, layers=None, d_model=None, vocab=None, heads=None):
    """Shrink an assigned config to laptop scale, same family/topology."""
    upd = {}
    if layers:
        upd["n_layers"] = layers
        upd["global_layers"] = tuple(
            i for i in cfg.global_layers if i < layers) or (
                (0,) if cfg.family == "hybrid" else ())
        if cfg.family == "encdec":
            upd["encoder_layers"] = max(2, layers // 2)
    if d_model:
        ratio = d_model / cfg.d_model
        upd["d_model"] = d_model
        upd["d_ff"] = max(32, int(cfg.d_ff * ratio)) if cfg.d_ff else 0
        if cfg.family == "moe":
            upd["d_expert"] = max(32, int((cfg.d_expert or cfg.d_ff) * ratio))
            upd["n_experts"] = min(cfg.n_experts, 8)
            upd["top_k"] = min(cfg.top_k, 2)
    if heads:
        upd["n_heads"] = heads
        upd["n_kv"] = max(1, min(cfg.n_kv, heads))
        upd["head_dim"] = (d_model or cfg.d_model) // heads
    if vocab:
        upd["vocab"] = vocab
    return dataclasses.replace(cfg, **upd)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train runs on 'cuda' by "
                           "default and no CUDA device is available; ask "
                           "for the CPU with device='cpu'")
    return device


def train_loop(cfg, opt_cfg, data_cfg, mesh, steps: int, ckpt_dir: str,
               save_interval: int = 50, log_every: int = 10,
               fail_at_step: int = -1, seed: int = 0, device="cuda"):
    """Runs (or resumes) training; returns (final state, loss history).
    ``mesh`` must be None (one device)."""
    if mesh is not None:
        raise NotImplementedError("a mesh needs the distributed item "
                                  "(ROADMAP.md A.7); pass mesh=None")
    device = _device(device)
    mgr = CheckpointManager(ckpt_dir, save_interval=save_interval, keep=3)
    hb = Heartbeat(os.path.join(ckpt_dir, "heartbeat.json"))
    straggler = StragglerDetector()

    if mgr.latest_step() is None:
        state = ts.init_state(torch.Generator(device=device).manual_seed(
            seed), cfg, opt_cfg, device)
        start = 0
    else:
        # restore into an uninitialized model of the same shapes
        like = ts.state_for(model_zoo.build(cfg, device), opt_cfg)
        state, start = mgr.restore_latest(like)
        start = start + 1
        print(f"[train] resumed from step {start - 1}")

    step_fn = ts.make_train_step(cfg, opt_cfg)
    history = []
    accum = max(cfg.accum_steps, 1)
    for step in range(start, steps):
        if step == fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        straggler.start()
        batch = make_batch(cfg, data_cfg, step, accum=accum, device=device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        straggler.stop(step)
        hb.beat(step)
        history.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if mgr.should_save(step) or step == steps - 1:
            mgr.save(step, state)
    print(f"[train] straggler report: {straggler.report()}")
    return state, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCHS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--mesh", choices=["none", "debug", "pod"],
                    default="debug",
                    help="none and debug: one device; pod needs the "
                         "distributed item")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-config", action="store_true",
                    help="use the assigned full config")
    args = ap.parse_args(argv)

    if args.mesh == "pod":
        raise NotImplementedError("--mesh pod needs the distributed item "
                                  "(ROADMAP.md A.7)")
    cfg = registry.get_config(args.arch)
    if not args.full_config:
        cfg = reduce_config(cfg, args.layers, args.d_model, args.vocab,
                            args.heads)
        cfg = dataclasses.replace(cfg, accum_steps=1, dtype="float32")
    opt_cfg = AdamWConfig(lr=args.lr, eight_bit=cfg.opt_8bit,
                          warmup_steps=max(args.steps // 20, 5),
                          decay_steps=args.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                          seq_len=args.seq)
    _, history = train_loop(cfg, opt_cfg, data_cfg, None, args.steps,
                            os.path.join(args.ckpt_dir, cfg.name),
                            device=args.device)
    print(json.dumps({"first_loss": history[0], "last_loss": history[-1]}))


if __name__ == "__main__":
    main()
