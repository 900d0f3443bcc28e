"""The readings that a cell's check limits are set from, in one process.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--out file.jsonl]

For each seed: the cell's inputs, one request through the timed path
(the same public calls as ``bench/run.py``'s window, after one warm-up
request) and the numbers that decide ``correct``, against the plain
reference; for each control seed, the reference itself in the program's
place, in float32 with its matrix products in TF32 (the step below the
configuration's float32 with TF32 off), and the same numbers. One JSON
line per reading. Needs a card; the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from bench import generate, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.Spec()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    ref = spec.routine(traffic["routine"])
    from repro_torch import linalg
    factor = getattr(linalg, traffic["factor"])
    solve = getattr(linalg, traffic["solve"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def judge(a, b, got, x):
        sols = harness._Solutions(x, 1)
        sols.add(x)
        return harness.check(ref, a, b, got, sols, limits)

    with linalg.use(policy=traffic["policy"], device="cuda"):
        warm, res = False, None
        for side, chosen in (("program", seeds(args.seeds)),
                             ("control", seeds(args.control_seeds))):
            for seed in chosen:
                a, b = generate.make_inputs(config, traffic, ref, seed, dev)
                t0 = time.perf_counter()
                if side == "program":
                    if not warm:
                        res = factor(a)
                        solve(res, b)
                        warm = True
                    res = factor(a)
                    x = solve(res, b)
                    got = harness._result_parts(res)
                else:
                    got = ref.factor(a, tf32=True)
                    x = ref.solve(got, b, tf32=True)
                torch.cuda.synchronize(dev)
                seconds = time.perf_counter() - t0
                t1 = time.perf_counter()
                verdict = judge(a, b, got, x)
                emit({"workload": args.workload, "side": side, "seed": seed,
                      "ok": verdict["ok"], "request_s": seconds,
                      "check_s": time.perf_counter() - t1,
                      "numbers": {k: v["value"]
                                  for k, v in verdict["numbers"].items()},
                      "device": torch.cuda.get_device_name(dev)})
                a = b = got = x = res = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
