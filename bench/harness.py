"""One run of one cell: set-up, the measured window, the trace, the check.

:func:`run` is what ``bench/run.py`` calls once it has found the cards
the cell asks for; the tests call it on the CPU at a tiny size. It finds
everything by name from ``BENCHMARK.json`` (:class:`Spec`), drives the
port only through the public ``repro_torch.linalg`` calls that the
traffic file names, under the dispatch policy it names (``model``: the
hand-written kernels, planned by the port's cost model, no tuning), and
returns the result line as a dict.

A request is one factorization call and one solve call on the whole
batch, ending in a synchronize; the window runs whole requests back to
back, one client in a closed loop, each on the same seeded batch. Every
request's solution is kept (copied into a buffer after its clock has
stopped; in the traced part, after the profiler has closed), and the
last request's factorization; after the window they are compared with
the plain reference, worked out again in float64 from the same inputs,
in blocks of items.

With ``--trace 1`` the window opens with a profiled part (at least
``TRACE_MIN_REQUESTS`` requests and ``TRACE_MIN_SECONDS``) and runs on
without the profiler, which slows the host; readers that set device time
against a request's time take the latter from the unprofiled part.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
WARMUP_REQUESTS = 2
TRACE_MIN_REQUESTS = 3
TRACE_MIN_SECONDS = 1.0
CHECK_ITEMS = 256                # items of a reference block


class Spec:
    """``BENCHMARK.json`` and the files it names, found by name.

    ``root`` holds ``BENCHMARK.json``; ``bench`` is the directory of the
    traffic mixes, limits, driver references and metric readers."""

    def __init__(self, root: str = ROOT, bench: str = HERE):
        self.root, self.bench = root, bench
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.data = json.load(fh)

    def _named(self, key: str, name: str) -> Dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> Dict:
        return self._named("workloads", name)

    def config(self, name: str) -> Dict:
        return self._json(os.path.join(self.root,
                                       self._named("configs", name)["file"]))

    def traffic(self, name: str) -> Dict:
        return self._json(os.path.join(self.bench, "traffic", name + ".json"))

    def limits(self, cell: str) -> Dict:
        return self._json(os.path.join(self.bench, "limits", cell + ".json"))

    def routine(self, name: str):
        """The plain reference module of one LAPACK driver, with its
        LAWN 41 count and its kind of item (``bench/reference``)."""
        return load_module(os.path.join(self.bench, "reference", name + ".py"),
                           "bench_reference_" + name)

    def metrics(self, key: str, cell: str) -> List[Dict]:
        """The ``key`` ("end_to_end" / "per_layer") metrics this cell
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.data[key]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.bench, "metrics", metric + ".py")
        return load_module(path, "bench_metric_" + metric.replace(".", "_")
                           ).read

    @staticmethod
    def _json(path: str) -> Dict:
        with open(path) as fh:
            return json.load(fh)


def load_module(path: str, name: str):
    """Import the file ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class WindowView:
    """What the end-to-end readers see: the window's requests on the
    host clock."""
    latencies_s: List[float]        # each request, start to synchronize
    span_s: float                   # first request's start to last's end
    flops_per_request: float        # LAWN 41 count
    setup_s: float                  # process start to the first request


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers see: the traced requests, and the
    window's unprofiled requests on the host clock."""
    requests: int
    window_s: float                 # traced window, trace clock
    busy_s: float                   # union of device activity in it
    kernels: Dict[str, List[float]]     # name -> [device seconds, launches]
    launches: List[Dict]            # the port's launch records
    classify: Callable[[str], Optional[str]]    # name -> csrc stem / None
    flops_per_request: float
    dtype: str
    untraced_latencies_s: List[float]   # each unprofiled request
    untraced_span_s: float          # their first start to last end


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(k for k in sys.modules if k.split(".")[0] in BANNED)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Solutions:
    """Every request's solution, copied into preallocated chunks after the
    request's clock has stopped (no allocation inside the window)."""

    def __init__(self, like: torch.Tensor, capacity: int):
        self.like, self.capacity = like, capacity
        self.chunks: List[torch.Tensor] = [self._chunk()]
        self.count = 0

    def _chunk(self) -> torch.Tensor:
        return torch.empty((self.capacity, *self.like.shape),
                           dtype=self.like.dtype, device=self.like.device)

    def add(self, x: torch.Tensor) -> None:
        i = self.count % self.capacity
        if i == 0 and self.count:
            self.chunks.append(self._chunk())
        self.chunks[-1][i].copy_(x)
        self.count += 1

    def blocks(self):
        left = self.count
        for c in self.chunks:
            yield c[:min(left, self.capacity)]
            left -= self.capacity


def _result_parts(res) -> Dict[str, torch.Tensor]:
    return {k: getattr(res, k) for k in ("factors", "tau", "pivots")
            if getattr(res, k, None) is not None}


def check(ref, a: torch.Tensor, b: torch.Tensor, got: Dict[str, torch.Tensor],
          solutions, limits: Dict, items: int = CHECK_ITEMS) -> Dict:
    """Compare the program's last factorization ``got`` and every kept
    solution with the reference, worked out in float64 from ``a`` and
    ``b``, ``items`` items at a time. Returns the numbers, each beside
    its limit, and the requests whose solution failed its limit."""
    numbers: Dict[str, float] = {}
    per_request: Optional[torch.Tensor] = None
    for i0 in range(0, a.shape[0], items):
        i1 = min(i0 + items, a.shape[0])
        fact = ref.factor(a[i0:i1].double())
        x_ref = ref.solve(fact, b[i0:i1].double())
        block = ref.factor_numbers(fact, {k: v[i0:i1] for k, v in got.items()})
        worst = []
        for xs in solutions.blocks():
            worst.append(_rel(xs[:, i0:i1], x_ref).amax(dim=1))
        worst = torch.cat(worst)
        per_request = worst if per_request is None else \
            torch.maximum(per_request, worst)
        block["x_rel"] = float(worst.max())
        for k, v in block.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        del fact, x_ref
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits name numbers the reference does not give: "
                       f"{sorted(missing)}")
    failed = int((per_request > limits["x_rel"]["limit"]).sum()) \
        if "x_rel" in limits else 0
    return {"numbers": {k: {"value": numbers[k], "limit": limits[k]["limit"]}
                        for k in limits},
            "failed_requests": failed,
            "ok": failed == 0 and all(
                math.isfinite(numbers[k]) and numbers[k] <= limits[k]["limit"]
                for k in limits)}


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(requests, items) relative 2-norm gaps of solutions to ``want``."""
    diff = (got.double() - want).flatten(2).norm(dim=-1)
    rel = diff / want.flatten(1).norm(dim=-1)
    return torch.nan_to_num(rel, nan=float("inf"))


def _timed(request, device: torch.device, lat: List[float],
           starts: List[float]):
    """One request of the window, its clock stopped at the synchronize:
    (its factorization, its solution)."""
    s = time.perf_counter()
    res, x = request()
    _sync(device)
    starts.append(s)
    lat.append(time.perf_counter() - s)
    return res, x


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, spec: Optional[Spec] = None
        ) -> Tuple[Dict, List[str]]:
    """One run of ``workload``: (the result line as a dict, keys in the
    contract's order and ``checks`` last; the JAX modules loaded when the
    window closed, for which ``bench/run.py`` prints no result).
    ``t_start`` is the process's start on ``time.perf_counter``."""
    spec = spec or Spec()
    cell = spec.cell(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    ref = spec.routine(traffic["routine"])

    from torch.profiler import record_function

    from bench import generate, profile_reader
    from bench.kernels import Classifier, handwritten
    import repro_torch
    from repro_torch import linalg
    from repro_torch.kernels import launch_record
    t_import = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a, b = generate.make_inputs(config, traffic, ref, seed, device)
    _sync(device)
    t_inputs = time.perf_counter()
    flops = config["batch"] * ref.flops(config["m"], config["n"],
                                        traffic["nrhs"])
    factor = getattr(linalg, traffic["factor"])
    solve = getattr(linalg, traffic["solve"])

    def request():
        res = factor(a)
        return res, solve(res, b)

    def annotated():
        with record_function(profile_reader.CALL_PREFIX + traffic["factor"]):
            res = factor(a)
        with record_function(profile_reader.CALL_PREFIX + traffic["solve"]):
            return res, solve(res, b)

    lat: List[float] = []
    starts: List[float] = []
    summary = recs = None
    traced_requests = 0
    with linalg.use(policy=traffic["policy"], device=device.type):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        for _ in range(WARMUP_REQUESTS):
            res = x = None
            res, x = request()
            _sync(device)
        per_request = (time.perf_counter() - t0) / WARMUP_REQUESTS
        sols = _Solutions(x, int(seconds / max(per_request, 1e-4) * 2) + 16)
        res = x = None
        gc.collect()
        setup_s = time.perf_counter() - t_start
        print(f"setup_s {setup_s:.3f}: imports {t_import - t_start:.3f}, "
              f"inputs {t_inputs - t_import:.3f}, {WARMUP_REQUESTS} warm-up "
              f"requests {per_request * WARMUP_REQUESTS:.3f}",
              file=sys.stderr)

        w0 = time.perf_counter()
        if trace:
            held = []       # copied after the profiler, not inside it
            with profile_reader.traced(device) as prof, \
                    launch_record.record_launches() as recs:
                with record_function(profile_reader.WINDOW):
                    while (len(lat) < TRACE_MIN_REQUESTS or
                           time.perf_counter() - w0 < TRACE_MIN_SECONDS):
                        res = None
                        res, x = _timed(annotated, device, lat, starts)
                        held.append(x)
            traced_requests = len(lat)
            for x in held:
                sols.add(x)
            held = x = None
        # a traced run also has unprofiled requests for its readers
        while (len(lat) - traced_requests <
               (TRACE_MIN_REQUESTS if trace else 1) or
               starts[-1] + lat[-1] - w0 < seconds):
            res = None
            res, x = _timed(request, device, lat, starts)
            sols.add(x)
        x = None
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    banned = banned_modules()
    got = _result_parts(res)
    res = None

    if trace:
        summary = profile_reader.read(prof)
        prof = None
        view = TraceView(
            requests=traced_requests, window_s=summary["window_s"],
            busy_s=summary["busy_s"], kernels=summary["kernels"],
            launches=list(recs),
            classify=Classifier(handwritten(
                os.path.dirname(repro_torch.__file__))).stem,
            flops_per_request=flops, dtype=config["dtype"],
            untraced_latencies_s=lat[traced_requests:],
            untraced_span_s=starts[-1] + lat[-1] - starts[traced_requests])
    else:
        view = WindowView(latencies_s=lat,
                          span_s=starts[-1] + lat[-1] - starts[0],
                          flops_per_request=flops, setup_s=setup_s)
    metrics = {}
    for m in spec.metrics("per_layer" if trace else "end_to_end", workload):
        value = spec.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    verdict = check(ref, a, b, got, sols, limits)
    out = {"correct": bool(verdict["ok"]),
           "attempted": len(lat), "failed": verdict["failed_requests"],
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = verdict["numbers"]
    return out, banned
