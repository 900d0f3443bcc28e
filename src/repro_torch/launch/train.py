"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch <id> ...``

The production loop's shape: sharded state on the mesh, the counter-based
data pipeline (each rank generates its rows), atomic keep-N checkpointing
with restore-on-start (a restarted job resumes from the latest step by
itself, on this mesh whatever mesh wrote it), heartbeat and straggler
detection, gradient accumulation. It runs on ``cuda`` unless asked for
the CPU (``--device cpu``).

Meshes: one process per rank, started by ``torchrun`` (or any launcher
that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``):
``--mesh debug`` is ``make_debug_mesh(data=max(1, n // 2), model=min(2,
n))`` over the world's ``n`` ranks, ``--mesh pod`` the 16 x 16 production
mesh. The process group's backend follows from the ranks' devices
(:func:`backend_for`): nccl where each local rank has a card of its own,
gloo for CPU ranks or ranks that share a card. Started as one plain
process, ``debug`` and ``none`` train on one device
(``train_loop(mesh=None)``).

Reduced configs by default (``--layers`` / ``--d-model`` / ``--heads`` /
``--vocab``, in f32); ``--full-config`` trains the assigned config.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.models.transformer import identity_shard
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
    ``mesh``: a DeviceMesh (every rank of it calls; the state at
    ``state_specs``, the batch at ``batch_specs``, on the mesh's device)
    or None (one device, on ``device``)."""
    device = _device(device if mesh is None else sh.mesh_device(mesh))
    lead = mesh is None or dist.get_rank() == int(mesh.mesh.min())
    mgr = CheckpointManager(ckpt_dir, save_interval=save_interval, keep=3)
    hb = Heartbeat(os.path.join(ckpt_dir, "heartbeat.json"))
    straggler = StragglerDetector()
    accum = max(cfg.accum_steps, 1)
    shard_fn = identity_shard if mesh is None else sh.make_shard_fn(mesh)
    batch_sharding = None

    if mgr.latest_step() is None:
        state = ts.init_state(torch.Generator(device=device).manual_seed(
            seed), cfg, opt_cfg, device)
        if mesh is not None:
            state = sh.place_state(state, mesh)
        start = 0
    else:
        # restore into an uninitialized model of the same shapes (on the
        # meta device for a mesh: each rank reads only its blocks)
        like = ts.state_for(model_zoo.build(
            cfg, device if mesh is None else "meta"), opt_cfg)
        shardings = None if mesh is None else sh.to_shardings(
            sh.state_specs(sh.state_shapes(like), mesh), mesh)
        state, start = mgr.restore_latest(like, shardings=shardings)
        start = start + 1
        if lead:
            print(f"[train] resumed from step {start - 1}")
    if mesh is not None:
        b = data_cfg.global_batch // accum
        shape = (b, data_cfg.seq_len) if accum == 1 else \
            (accum, b, data_cfg.seq_len)
        batch_sharding = sh.NamedSharding(mesh, sh.batch_specs(
            {"tokens": shape}, mesh, accum)["tokens"])

    step_fn = ts.make_train_step(cfg, opt_cfg, shard_fn)
    history = []
    for step in range(start, steps):
        if step == fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        straggler.start()
        batch = make_batch(cfg, data_cfg, step, accum=accum, device=device,
                           sharding=batch_sharding)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        straggler.stop(step)
        if lead:
            hb.beat(step)
        history.append(loss)
        if lead and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if mgr.should_save(step) or step == steps - 1:
            mgr.save(step, state)
    if lead:
        print(f"[train] straggler report: {straggler.report()}")
    return state, history


def make_mesh(kind: str, device_type=None):
    """``--mesh``'s mesh over the world's ranks: "pod" the production
    mesh, "debug" ``make_debug_mesh(data=max(1, n // 2), model=min(2,
    n))``, "none" (or no process group) None."""
    if kind == "none" or not dist.is_initialized():
        if kind == "pod":
            raise RuntimeError("--mesh pod needs one process per rank of "
                               "the 16 x 16 mesh (torchrun)")
        return None
    if kind == "pod":
        return make_production_mesh(device_type=device_type)
    n = dist.get_world_size()
    return make_debug_mesh(data=max(1, n // 2), model=min(2, n),
                           device_type=device_type)


def backend_for(device: str) -> str:
    """The process group's backend for ranks on ``device``: nccl where
    every local rank (``LOCAL_WORLD_SIZE``, as torchrun sets it) has a
    card of its own, else gloo (CPU ranks, or ranks that share a card:
    NCCL refuses two ranks on one card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


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
                    help="debug: (max(1, n // 2), min(2, n)) over the "
                         "world's n ranks (one device when started as one "
                         "plain process); pod: 16 x 16 ranks; none: one "
                         "device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-config", action="store_true",
                    help="use the assigned full config")
    args = ap.parse_args(argv)

    started = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if started:
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend_for(args.device))
    try:
        _main(args)
    finally:
        if started:
            dist.destroy_process_group()


def _main(args) -> None:
    mesh = make_mesh(args.mesh, torch.device(args.device).type)
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
    _, history = train_loop(cfg, opt_cfg, data_cfg, mesh, args.steps,
                            os.path.join(args.ckpt_dir, cfg.name),
                            device=args.device)
    if mesh is None or dist.get_rank() == 0:
        print(json.dumps({"first_loss": history[0],
                          "last_loss": history[-1],
                          "mesh": None if mesh is None
                          else dict(zip(mesh.mesh_dim_names,
                                        map(int, mesh.shape)))}))


if __name__ == "__main__":
    main()
