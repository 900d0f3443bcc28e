"""Where a batched B2 launch spends its time: each task's phases, on the card.

    PYTHONPATH=src python3 src/repro_torch/tools/b2_split.py \
        [--items 64] [--nb 128] [--n 384] [--form syrk|lu|lu0] [--dtype f32]

builds ``csrc/trsm_gemm.cu`` once more with ``-DREPRO_B2_SPLIT`` (a library
of its own beside the production one, under ``build/repro_torch/``), in
which thread 0 of each CTA of the batched kernel writes ``%globaltimer`` at
the points of each task it claims. It launches the batched B2 on the
batched drivers' views (random inputs from seed 0; ``lu0`` is ``lu`` at
m = 0, the solve alone), once to warm and once to read, and prints one
JSON line: the card's name and power limit, the launch's span (first claim
to last end), the CTAs, and for each kind of task its count and the
microseconds summed over tasks of each phase: a solve block's L11 staging,
AP load, left-looking updates, diagonal blocks and write-out; a C tile's
wait for its item's X, main loop and epilogue (f64: its C reads apart;
f32 and bf16 stage C as the tile starts); with the CTA-microseconds
of the launch (span x CTAs) the phases share. The stamps cost a few global
stores a task; the span is the instrumented kernel's, not the production
one's (``tools/kernel_ab.py`` times that).
"""
import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused as fk

STEPS, TASKS = 8, 1 << 16       # csrc/trsm_gemm.cu: SPLIT_STEPS, SPLIT_TASKS


def views(items, nb, n, form, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(items, nb + n, nb + n, generator=gen,
                    device="cuda").to(dtype)
    a[:, :nb, :nb] = (torch.tril(a[:, :nb, :nb], -1) / nb
                      + 1.5 * torch.eye(nb, device="cuda", dtype=dtype))
    if form == "syrk":
        return (a[:, :nb, :nb], a[:, nb:, :nb].mT, None, a[:, nb:, nb:])
    m = nb if form == "lu0" else nb + n
    return (a[:, :nb, :nb], a[:, :nb, nb:], a[:, nb:m, :nb], a[:, nb:m, nb:])


def main(items, nb, n, form, dtype) -> dict:
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DREPRO_B2_SPLIT",)
    lib = _build.library("trsm_gemm")
    lib.repro_trsm_gemm_split.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.repro_trsm_gemm_split.restype = ctypes.c_int
    args = views(items, nb, n, form, dtype)
    kind = "syrk" if form == "syrk" else "lu"
    call = lambda: fk.trsm_gemm(*args, form=kind, unit_diag=kind == "lu")
    call()
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    grid = fk.trsm_gemm.last_launch["grid"]
    plan = fk.trsm_gemm.last_launch["plan"]
    solves = -(-n // 128) * 128 // plan.width
    m = args[3].shape[-2]
    rows = fk.TRSM_GEMM_BATCHED_TILE[plan.update][0]
    tiles = -(-m // rows) * -(-n // 128) if m else 0
    tasks = items * (solves + tiles)
    assert tasks <= TASKS, tasks
    buf = (ctypes.c_ulonglong * (tasks * STEPS))()
    _build.check(lib.repro_trsm_gemm_split(buf, ctypes.sizeof(buf)),
                 "repro_trsm_gemm_split")
    rows = [list(buf[t * STEPS:(t + 1) * STEPS]) for t in range(tasks)]
    start = min(r[0] for r in rows)
    us = lambda ns: ns / 1e3
    out = {"solve": {"tasks": 0, "stage_l11_us": 0.0, "load_ap_us": 0.0,
                     "left_looking_us": 0.0, "diagonal_us": 0.0,
                     "write_us": 0.0},
           "tile": {"tasks": 0, "wait_us": 0.0, "main_loop_us": 0.0,
                    "epilogue_us": 0.0, "epilogue_c_reads_us": 0.0}}
    end = 0
    for r in rows:
        if r[7] >> 62:
            s = out["solve"]
            s["tasks"] += 1
            s["stage_l11_us"] += us(r[1] - r[0])
            s["load_ap_us"] += us(r[2] - r[1])
            s["left_looking_us"] += us(r[5])
            s["diagonal_us"] += us(r[3] - r[2] - r[5])
            s["write_us"] += us(r[4] - r[3])
            end = max(end, r[4])
        else:
            t = out["tile"]
            t["tasks"] += 1
            t["wait_us"] += us(r[1] - r[0])
            t["main_loop_us"] += us(r[2] - r[1])
            t["epilogue_us"] += us(r[3] - r[2])
            if r[4]:                  # f64: C read, before the stores
                t["epilogue_c_reads_us"] += us(r[4] - r[2])
            end = max(end, r[3])
    span = us(end - start)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"card": smi, "shape": f"{items} x nb={nb} n={n} {form} "
            f"{str(dtype)[6:]}", "plan": list(plan), "grid": grid,
            "span_us": span, "cta_us": span * grid, **out}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--items", type=int, default=64)
    p.add_argument("--nb", type=int, default=128)
    p.add_argument("--n", type=int, default=384)
    p.add_argument("--form", default="syrk", choices=("syrk", "lu", "lu0"))
    p.add_argument("--dtype", default="f32", choices=("f32", "f64", "bf16"))
    a = p.parse_args()
    dt = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}[a.dtype]
    print(json.dumps(main(a.items, a.nb, a.n, a.form, dt)))
