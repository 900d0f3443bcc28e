"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decides ``correct`` beside its limit, which also end standard
error. Exits 1 with no result line when the cards the cell asks for are
not there (nothing falls back to the CPU), when JAX or the JAX package is
loaded once the window has closed, or when anything else fails.

The port's caches stay inside the checkout at fixed paths: its nvcc
libraries in ``build/repro_torch/`` (the port's own), and the PyTorch
extension and Triton caches in ``build/bench/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench", sub)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from bench import harness

    spec = harness.Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    out, banned = harness.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, spec)
    banned = sorted(set(banned) | set(harness.banned_modules()))
    if banned:
        print(f"JAX or the JAX package was loaded: {banned}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
