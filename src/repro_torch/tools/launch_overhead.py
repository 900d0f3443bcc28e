"""Host time of the linalg main path and of single kernel launches, to set
two checkouts of the port side by side on one card.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/launch_overhead.py \
        --label NAME [--record]

prints one JSON line: the label, the card's name and power limit
(``nvidia-smi``), the seconds of each of 3 warm calls of
``linalg.cholesky`` / ``lu`` / ``solve`` at 8192 f32 and ``qr`` at 4096
f32 (seed 0, ``linalg.use(policy="model", device="cuda")``, each call
ended by ``torch.cuda.synchronize()``) and their medians, and the host
microseconds a launch takes back to back (2000 launches, median of 5
rounds) for B1's ``gemv`` (an 8064 x 128 matrix by a vector, the TRSM
update's shape) and for B2 (nb 128 over 256 columns, syrk form): both
kernels run in less time than their launch, so the rate is the host's.
``--record`` adds the same launches inside a launch-record scope
(``repro_torch.kernels.launch_record``). Run it with the ``src`` of each
checkout in turn in one machine session (A, B, B, A): hosts differ.
"""
import argparse
import json
import statistics
import subprocess
import time

import torch

N, N_QR, REPS, LAUNCHES, ROUNDS = 8192, 4096, 3, 2000, 5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _seconds(fn) -> list:
    fn()                                              # warm
    out = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _launch_us(fn) -> float:
    fn()
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / LAUNCHES * 1e6)
    return statistics.median(rounds)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--record", action="store_true",
                    help="also time the launches inside a record scope")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_overhead: no CUDA device")
    from repro_torch import linalg
    from repro_torch.kernels import _build, fused, gemm

    _build.build_all(("gemm", "trsm_gemm"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    g = rnd(N, N)
    s = g @ g.T / N + torch.eye(N, device="cuda")
    rhs = rnd(N)
    q = rnd(N_QR, N_QR)
    out = {"label": args.label, "card": _card(), "torch": torch.__version__}
    with linalg.use(policy="model", device="cuda"):
        for name, fn in (("cholesky f32 8192", lambda: linalg.cholesky(s)),
                         ("lu f32 8192", lambda: linalg.lu(g)),
                         ("solve f32 8192", lambda: linalg.solve(g, rhs)),
                         ("qr f32 4096", lambda: linalg.qr(q))):
            secs = _seconds(fn)
            out[name] = {"s": secs, "median_s": statistics.median(secs)}
    a, x = rnd(8064, 128), rnd(128, 1)
    l11 = torch.linalg.cholesky(s[:128, :128]).contiguous()
    panel, c = rnd(128, 256), rnd(256, 256)
    launches = {
        "gemv 8064x128 by a vector": lambda: gemm.gemm(a, x),
        "trsm_gemm nb 128 n 256 syrk": lambda: fused.trsm_gemm(
            l11, panel, None, c, form="syrk")}
    before = gemm.gemm.variant_launches["gemv"]
    for name, fn in launches.items():
        out[f"{name} us"] = _launch_us(fn)
    assert gemm.gemm.variant_launches["gemv"] > before, "gemv not launched"
    if args.record:
        from repro_torch.kernels.launch_record import record_launches
        for name, fn in launches.items():
            with record_launches() as rec:
                out[f"{name} us, recording"] = _launch_us(fn)
            assert len(rec) == (1 + ROUNDS * LAUNCHES), len(rec)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
