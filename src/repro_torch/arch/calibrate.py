"""Measured-machine calibration: fit a MachineSpec from micro-benchmarks.

Port of ``repro.arch.calibrate``. A small micro-benchmark suite runs on
one device under the adaptive repetition controller of
:mod:`repro_torch.tune.measure`:

* **GEMM ladder** - square float32 ``torch.matmul`` of increasing size
  (TF32 off, stated in the evidence: the reference times XLA's own
  ``x @ y``); the best sustained flop rate fits ``PEGeometry.peak_flops``.
* **Streaming copy + reduction** - ``x + 0.0`` and ``x.sum()`` over a large
  array; the best sustained byte rate fits ``MemorySpec.hbm_bw``.
* **Dependent chains per op class** - a loop-carried mul / add / div / sqrt
  chain exposes each class's dependent-op latency like an under-filled
  pipeline (the paper's eq.-2 hazard term) and fits ``FPUSpec.depths``.
  On the card the chain is one kernel (:mod:`repro_torch.kernels.fpu_chain`:
  eager PyTorch would time one launch per op), which also reads the SM
  cycles of the chain, so each depth is that class's cycles per dependent
  op. On the CPU the chain is the kernel's plain version, one PyTorch op
  per step, so it times dispatch rather than the FPU; there the reference's
  rule applies: latency ratios anchored at the base spec's multiplier
  depth.

The fitted sections replace their counterparts in a base spec (``"h100"``
on the card, ``"cpu-host"`` on the CPU); power and area stay the base's,
since wall-clock micro-benchmarks cannot observe them. The result is a
frozen, JSON-serializable :class:`~repro_torch.arch.spec.MachineSpec`
named ``calibrated-<device type>`` (``calibrated-cuda``,
``calibrated-cpu``), registered into the machine registry. The suite runs
on the card unless the caller asks for the CPU (``backend="cpu"``).

By construction the fitted machine's modeled time for the best rung of the
GEMM ladder and of the stream suite equals the measured median;
:data:`CALIBRATION_TOLERANCE` is the band within which those residuals
must stay for a calibration to be considered sane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.arch import registry as _registry
from repro_torch.arch.spec import OP_CLASSES, MachineSpec

# |model_residual| band the best-rung micro-bench rows must satisfy
CALIBRATION_TOLERANCE = 0.35

# fitted pipeline depths are clamped into this range: >= 1 by FPUSpec's
# validation, <= 64 so one noisy chain sample cannot declare an absurd pipe
_DEPTH_RANGE = (1, 64)

# the base spec of each device type the suite runs on
BASE_MACHINES = {"cuda": "h100", "cpu": "cpu-host"}
# the suite's sizes where the caller names none: the reference's on the
# CPU; on the card a ladder into the thousands (the 132 SMs fill only
# there), streams over 1 GiB (far past the 50 MB L2) and chains long
# enough that the loop's own cost fades (4.52 cycles a mul at 4096 steps,
# 4.44 at 65536)
SUITE_SIZES = {
    "cpu": {"gemm_sizes": (64, 128, 256), "stream_elems": 1 << 22,
            "chain_iters": 256},
    "cuda": {"gemm_sizes": (1024, 2048, 4096, 8192),
             "stream_elems": 1 << 28, "chain_iters": 1 << 16},
}


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """A fitted machine plus the micro-bench evidence behind it.

    ``report`` rows carry ``{"bench", "params", "seconds_median",
    "seconds_spread", "reps", "converged", "modeled_s", "model_residual"}``,
    with ``modeled_s`` computed under the fitted machine.
    """

    machine: MachineSpec
    report: Tuple[Dict[str, Any], ...]
    backend: str

    def best_residual(self, bench: str) -> float:
        """Smallest |model_residual| over the rows of one bench family."""
        rs = [abs(r["model_residual"]) for r in self.report
              if r["bench"] == bench]
        if not rs:
            raise ValueError(f"no report rows for bench {bench!r}")
        return min(rs)

    def to_json(self) -> Dict[str, Any]:
        return {"backend": self.backend, "machine": self.machine.to_json(),
                "report": [dict(r) for r in self.report]}


def _measure_mod():
    # lazy: repro_torch.tune imports repro_torch.arch at package-import
    # time, so the arch package cannot import it back at module level
    from repro_torch.tune import measure
    return measure


def _device(backend):
    import torch
    dev = torch.device(backend)
    if dev.type not in BASE_MACHINES:
        raise ValueError(f"calibration runs on {tuple(BASE_MACHINES)}, not "
                         f"{backend!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calibration runs on 'cuda' by default and no "
                           "CUDA device is available; pass backend='cpu' to "
                           "calibrate the host")
    return dev


def run_microbenchmarks(gemm_sizes: Optional[Sequence[int]] = None,
                        stream_elems: Optional[int] = None,
                        chain_iters: Optional[int] = None,
                        reps: Optional[int] = None,
                        min_reps: int = 3, max_reps: int = 10,
                        rel_spread: float = 0.2,
                        backend: str = "cuda") -> Dict[str, Any]:
    """Run the calibration suite on ``backend`` (a device type); sizes
    left ``None`` take the device's :data:`SUITE_SIZES`.

    Returns raw evidence: per-rung GEMM measurements (+ flops), the two
    stream measurements (+ bytes), and the per-op-class chain latencies
    (+ ``cycles_per_op`` on the card). All timing goes through the
    adaptive controller (``reps=N`` pins exact rep counts).
    """
    import numpy as np
    import torch

    from repro_torch.kernels import fpu_chain as _fc

    dev = _device(backend)
    sizes = SUITE_SIZES[dev.type]
    gemm_sizes = sizes["gemm_sizes"] if gemm_sizes is None else gemm_sizes
    stream_elems = sizes["stream_elems"] if stream_elems is None \
        else stream_elems
    chain_iters = sizes["chain_iters"] if chain_iters is None \
        else chain_iters
    meas = _measure_mod()
    kw = dict(reps=reps, min_reps=min_reps, max_reps=max_reps,
              rel_spread=rel_spread)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev)

    rng = np.random.default_rng(0)
    gemm = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32, as stated
    try:
        for n in gemm_sizes:
            a, b = normal(n, n), normal(n, n)
            m = meas.measure(torch.matmul, a, b, **kw)
            gemm.append({"n": int(n), "flops": 2.0 * n ** 3,
                         "measurement": m, "allow_tf32": False})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    itemsize = 4
    x = normal(int(stream_elems))
    stream = []
    # copy: one read + one write stream; reduction: one read stream
    m = meas.measure(lambda v: v + 0.0, x, **kw)
    stream.append({"kind": "copy", "bytes": 2 * int(stream_elems) * itemsize,
                   "measurement": m})
    m = meas.measure(torch.sum, x, **kw)
    stream.append({"kind": "reduction", "bytes": int(stream_elems) * itemsize,
                   "measurement": m})
    del x

    # loop-carried dependent chains: per step exactly one op of the class
    # on each lane of an 8-lane value
    v0 = torch.full((_fc.LANES,), 2.0, dtype=torch.float32, device=dev)
    iters = int(chain_iters)
    chains = {}
    for cls in OP_CLASSES:
        m = meas.measure(lambda v, c=cls: _fc.fpu_chain(c, v, iters)[0], v0,
                         **kw)
        row = {"iters": iters, "measurement": m,
               "latency_s": m.seconds_median / max(iters, 1)}
        if dev.type == "cuda":
            cycles = sorted(int(_fc.fpu_chain(cls, v0, iters)[1])
                            for _ in range(5))
            row["cycles_per_op"] = cycles[2] / max(iters, 1)
            row["latency_s"] = row["cycles_per_op"] / \
                _registry.get(BASE_MACHINES["cuda"]).pe.mxu_clock
        chains[cls] = row

    return {"backend": dev.type, "gemm": gemm, "stream": stream,
            "chains": chains}


def _fit_depths(chains: Mapping[str, Mapping[str, Any]],
                base: MachineSpec) -> Dict[str, int]:
    """Effective pipeline depth per op class: the chain's cycles per
    dependent op where the evidence has them (the card's chain kernel),
    else the reference's rule - latency ratios anchored at the base spec's
    multiplier depth (wall clock alone fixes ratios, not the cycle time)."""
    lo, hi = _DEPTH_RANGE
    if all("cycles_per_op" in chains[k] for k in OP_CLASSES):
        return {k: min(max(int(round(chains[k]["cycles_per_op"])), lo), hi)
                for k in OP_CLASSES}
    lat = {k: float(chains[k]["latency_s"]) for k in OP_CLASSES}
    anchor = base.fpu.depths["mul"] / max(lat["mul"], 1e-12)
    return {k: min(max(int(round(lat[k] * anchor)), lo), hi)
            for k in OP_CLASSES}


def fit_machine(results: Mapping[str, Any],
                base: Optional[MachineSpec] = None,
                name: Optional[str] = None) -> MachineSpec:
    """Fit FPU / memory / PE parameters from :func:`run_microbenchmarks`
    evidence into a copy of ``base`` (default: ``"h100"`` for ``cuda``
    evidence, ``"cpu-host"`` otherwise)."""
    backend = results["backend"]
    if base is None:
        base = _registry.get(BASE_MACHINES.get(backend, "cpu-host"))
    name = name or f"calibrated-{backend}"

    peak = max(r["flops"] / r["measurement"].seconds_median
               for r in results["gemm"])
    bw = max(r["bytes"] / r["measurement"].seconds_median
             for r in results["stream"])
    depths = _fit_depths(results["chains"], base)

    return MachineSpec(
        name=name,
        native_dtype="float32",          # the dtype the suite measured at
        fpu=dataclasses.replace(base.fpu, depths=depths),
        memory=dataclasses.replace(base.memory, hbm_bw=float(bw)),
        pe=dataclasses.replace(base.pe, peak_flops=float(peak)),
        power_area=base.power_area,      # not observable from wall clock
    )


def _report(results: Mapping[str, Any],
            machine: MachineSpec) -> Tuple[Dict[str, Any], ...]:
    """Modeled-vs-measured rows for the fitted machine."""
    meas = _measure_mod()
    peak = machine.pe.peak_flops
    bw = machine.memory.hbm_bw
    rows = []

    def row(bench, params, m, modeled_s):
        rows.append({"bench": bench, "params": params, **m.row_fields(),
                     "converged": m.converged, "modeled_s": modeled_s,
                     "model_residual": meas.model_residual(
                         modeled_s, m.seconds_median)})

    for r in results["gemm"]:
        n = r["n"]
        ai = r["flops"] / (3.0 * n * n * 4)         # A, B in; C out (f32)
        row("gemm", {"n": n}, r["measurement"],
            r["flops"] / min(peak, ai * bw))
    for r in results["stream"]:
        row("stream", {"kind": r["kind"]}, r["measurement"],
            r["bytes"] / bw)
    anchor_lat = results["chains"]["mul"]["latency_s"] \
        / machine.fpu.depths["mul"]
    for cls in OP_CLASSES:
        c = results["chains"][cls]
        params = {"op_class": cls, "iters": c["iters"]}
        if "cycles_per_op" in c:                    # the card's chain kernel
            params["cycles_per_op"] = c["cycles_per_op"]
        row("chain", params, c["measurement"],
            machine.fpu.depths[cls] * anchor_lat * c["iters"])
    return tuple(rows)


def calibrate_full(backend: Optional[str] = None,
                   base: Optional[MachineSpec] = None,
                   name: Optional[str] = None, *,
                   register: bool = True, overwrite: bool = True,
                   path: Optional[str] = None,
                   **bench_kwargs) -> CalibrationResult:
    """Run the suite on ``backend`` (default ``"cuda"``), fit a machine,
    register it, and return machine + evidence report. ``bench_kwargs``
    forward to :func:`run_microbenchmarks`; ``path`` also writes the
    fitted spec's JSON there."""
    results = run_microbenchmarks(backend=backend or "cuda", **bench_kwargs)
    machine = fit_machine(results, base=base, name=name)
    if register:
        _registry.register(machine, overwrite=overwrite)
    if path is not None:
        machine.save(path)
    return CalibrationResult(machine=machine, report=_report(results, machine),
                             backend=results["backend"])


def calibrate(backend: Optional[str] = None,
              base: Optional[MachineSpec] = None,
              name: Optional[str] = None, *,
              register: bool = True, overwrite: bool = True,
              path: Optional[str] = None,
              **bench_kwargs) -> MachineSpec:
    """Measure ``backend`` (default ``"cuda"``) and return the fitted,
    registered ``calibrated-<device type>`` :class:`MachineSpec`
    (:func:`calibrate_full` keeps the evidence report)."""
    return calibrate_full(backend, base, name, register=register,
                          overwrite=overwrite, path=path,
                          **bench_kwargs).machine


def load_or_calibrate(path: str, **calibrate_kwargs) -> MachineSpec:
    """Load ``path`` and register the spec if the file is a valid
    MachineSpec JSON; on a missing or corrupt file run :func:`calibrate`
    and write its result to ``path``."""
    try:
        spec = MachineSpec.load(path)
    except (OSError, ValueError):
        return calibrate(path=path, **calibrate_kwargs)
    if calibrate_kwargs.get("register", True):
        _registry.register(spec, overwrite=True)
    return spec
