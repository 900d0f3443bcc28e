"""Seconds of the sharded hymba-1.5b train step and decode step that
``chip_smoke.py``'s shard phase runs (4 layers at full width, f32, four
gloo ranks sharing one card on (data 2, model 2); 2 x 4096 tokens a step;
a batch of 4 decoding over f32 caches of 64 slots), to set two checkouts
of the port side by side on one card.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/shard_ab.py \\
        NAME [--steps 3] [--decode 6]

prints one JSON line from rank 0: the name, the card's name and power
limit (``nvidia-smi``), each step's seconds (host clock ending in a
synchronize, the ranks lined up by a barrier before each), their median
after the first, the first step's transport records by kind and axis
(count and bytes, remat's recompute and the backward included), the
same for one decode step, and the seconds of one op over "model" on
the card's tensors (an all-reduce of 4 bytes and an all-gather of 1 MiB
a rank; median of 20). Run it with each checkout's ``src`` in turn in
one machine session (A, B, B, A): hosts differ.
"""
import argparse
import dataclasses
import datetime
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def _sync_s(fn):
    """(result, seconds) of ``fn`` run to completion on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _records(moved):
    """{"kind axis": [count, bytes]} of transport records."""
    out = {}
    for t in moved:
        got = out.setdefault(f"{t.kind} {t.axis}", [0, 0])
        got[0] += 1
        got[1] += t.bytes
    return out


def _op_s(make, run, reps=20):
    """Median seconds of ``run(make())`` over ``reps`` calls, the ranks
    lined up before each."""
    import torch.distributed as dist
    times = []
    for _ in range(reps):
        x = make()
        dist.barrier()
        times.append(_sync_s(lambda: run(x))[1])
    return statistics.median(times)


def _rank(rank, directory, steps, decode_steps, out):
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/rdv", rank=rank,
        world_size=4, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_debug_mesh(2, 2, device_type="cuda")
        cfg = dataclasses.replace(reduce_config(
            registry.get_config("hymba-1.5b"), layers=4), dtype="float32")
        opt = optimizer.AdamWConfig(lr=3e-4, warmup_steps=5, decay_steps=100)
        state = sh.place_state(ts.init_state(torch.Generator(
            device="cuda").manual_seed(0), cfg, opt, "cuda"), mesh)
        data = DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=4096,
                          seed=0)
        bsh = sh.NamedSharding(mesh, sh.batch_specs({"tokens": (2, 4096)},
                                                    mesh)["tokens"])
        step_fn = ts.make_train_step(cfg, opt, sh.make_shard_fn(mesh))
        train_s, train_rec = [], None
        for i in range(steps):
            batch = make_batch(cfg, data, i, device="cuda", sharding=bsh)
            torch.cuda.synchronize()
            dist.barrier()
            with coll.record_transport() as moved:
                (state, _), s = _sync_s(lambda: step_fn(state, batch))
            train_s.append(s)
            train_rec = train_rec or _records(moved)
        del state
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(1)
        model = sh.shard_model(model_zoo.init(cfg, gen, "cuda"), mesh)
        toks = torch.randint(0, cfg.vocab, (4, decode_steps), generator=gen,
                             device="cuda")
        caches = sh.place_caches(model_zoo.init_caches(
            model, cfg, 4, 64, dtype=torch.float32), mesh)
        decode_s, decode_rec = [], None
        for i in range(decode_steps):
            torch.cuda.synchronize()
            dist.barrier()
            with coll.record_transport() as moved:
                _, s = _sync_s(lambda: sh.decode_step(
                    model, toks[:, i:i + 1], cfg, caches, i))
            decode_s.append(s)
            decode_rec = decode_rec or _records(moved)
        ops = {
            "all_reduce 4 B": _op_s(lambda: torch.ones(1, device="cuda"),
                                    lambda x: coll.all_reduce(
                                        x, mesh, "model", dist.ReduceOp.SUM)),
            "all_gather 1 MiB": _op_s(
                lambda: torch.ones(1 << 18, device="cuda"),
                lambda x: coll.all_gather_cat(x, mesh, "model", 0))}
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"train_step_s": train_s,
                           "train_step_median_s": statistics.median(
                               train_s[1:]),
                           "train_records": train_rec,
                           "decode_step_s": decode_s,
                           "decode_step_median_s": statistics.median(
                               decode_s[1:]),
                           "decode_records": decode_rec,
                           "model_op_s": ops}, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--decode", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_ab: no CUDA device", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        mp.spawn(_rank, args=(d, args.steps, args.decode, out), nprocs=4)
        with open(out) as f:
            row = json.load(f)
    print(json.dumps({"name": args.name, "card": smi, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
