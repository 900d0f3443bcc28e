"""ELAPS-style wall-clock measurement: per-rep samples + adaptive repetition.

Port of ``repro.tune.measure``, with the same defaults and the same
:class:`Measurement` fields. Wall-clock samples on a shared host are noisy
and skewed, so every experiment is timed as repeated samples summarized by
robust statistics (median + relative interquartile spread), repeating
until the spread tightens or a budget is hit (*The ELAPS Framework*,
arXiv:1504.08035):

:func:`measure`
    Times a callable and returns a :class:`Measurement`. One untimed
    warm-up call runs first (kernel builds, allocator growth, library
    heuristics); then each rep is one call inside its own timed region
    that ends in ``torch.cuda.synchronize()`` on the device of the
    operands - the reference's per-rep ``block_until_ready``. PyTorch
    returns before the card finishes, so a region without the synchronise
    would time the enqueue; one synchronise after the loop would pile the
    earlier reps onto the last sample. On the CPU there is nothing to
    synchronise.
:func:`repetition_controller`
    The pure-Python adaptive loop under :func:`measure`; takes any
    ``sample_fn() -> seconds``, so tests drive it with synthetic timers.
:func:`measure_wall_time`
    The scalar facade: the median of exactly ``reps`` samples.
:func:`model_residual`
    The modeled-vs-measured residual every sweep row records.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch import obs as _obs

# Defaults for adaptive measurement: start at MIN_REPS, stop as soon as
# the relative IQR is inside REL_SPREAD, never exceed MAX_REPS.
DEFAULT_MIN_REPS = 3
DEFAULT_MAX_REPS = 20
DEFAULT_REL_SPREAD = 0.10


def _quantile(sorted_samples: Tuple[float, ...], q: float) -> float:
    """Linear-interpolation quantile of pre-sorted samples (numpy's
    default method)."""
    n = len(sorted_samples)
    if n == 1:
        return sorted_samples[0]
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_samples[lo] * (1.0 - frac) + sorted_samples[hi] * frac


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Per-rep wall-clock samples summarized the ELAPS way.

    ``seconds_spread`` is the relative interquartile range,
    ``(q75 - q25) / median``; ``converged`` records whether it reached
    ``target_spread`` before the rep budget ran out.
    """

    samples: Tuple[float, ...]
    seconds_median: float
    seconds_spread: float
    reps: int
    converged: bool
    target_spread: float

    @classmethod
    def from_samples(cls, samples, target_spread: float = DEFAULT_REL_SPREAD
                     ) -> "Measurement":
        xs = tuple(float(s) for s in samples)
        if not xs:
            raise ValueError("Measurement needs at least one sample")
        s = tuple(sorted(xs))
        med = _quantile(s, 0.5)
        iqr = _quantile(s, 0.75) - _quantile(s, 0.25)
        spread = iqr / med if med > 0 else float("inf")
        return cls(samples=xs, seconds_median=med, seconds_spread=spread,
                   reps=len(xs), converged=spread <= target_spread,
                   target_spread=float(target_spread))

    @property
    def seconds_min(self) -> float:
        return min(self.samples)

    @property
    def seconds_mean(self) -> float:
        return sum(self.samples) / len(self.samples)

    def row_fields(self) -> dict:
        """The canonical per-row timing fields every sweep row carries."""
        return {"seconds_median": self.seconds_median,
                "seconds_spread": self.seconds_spread,
                "reps": self.reps}

    def to_json(self) -> dict:
        return {**self.row_fields(), "samples": list(self.samples),
                "converged": self.converged,
                "target_spread": self.target_spread}


def repetition_controller(sample_fn: Callable[[], float],
                          min_reps: int = DEFAULT_MIN_REPS,
                          max_reps: int = DEFAULT_MAX_REPS,
                          rel_spread: float = DEFAULT_REL_SPREAD) -> Measurement:
    """Sample ``sample_fn`` until the relative IQR of the samples is
    ``<= rel_spread`` (checked from ``min_reps`` on) or ``max_reps``
    samples have been taken; ``converged`` says which exit fired."""
    min_reps = int(min_reps)
    max_reps = int(max_reps)
    if min_reps < 1:
        raise ValueError(f"min_reps must be >= 1, got {min_reps}")
    if max_reps < min_reps:
        raise ValueError(f"max_reps ({max_reps}) must be >= min_reps "
                         f"({min_reps})")
    if not float(rel_spread) >= 0:
        raise ValueError(f"rel_spread must be >= 0, got {rel_spread!r}")
    samples = []
    while len(samples) < max_reps:
        samples.append(float(sample_fn()))
        if len(samples) >= min_reps:
            m = Measurement.from_samples(samples, rel_spread)
            if m.converged:
                return m
    return Measurement.from_samples(samples, rel_spread)


def _cuda_devices(args) -> Tuple[torch.device, ...]:
    """The distinct CUDA devices among the tensor arguments."""
    return tuple({a.device for a in args if isinstance(a, torch.Tensor)
                  and a.device.type == "cuda"})


def measure(f, *args, reps: Optional[int] = None,
            min_reps: int = DEFAULT_MIN_REPS,
            max_reps: int = DEFAULT_MAX_REPS,
            rel_spread: float = DEFAULT_REL_SPREAD) -> Measurement:
    """Measure ``f(*args)`` under the repetition controller.

    One untimed warm-up call runs first; each rep is one call timed on the
    host clock up to the end of ``torch.cuda.synchronize()`` on every CUDA
    device among ``args`` (none for CPU tensors). ``reps=N`` pins exactly
    ``N`` samples; otherwise the ``min_reps`` / ``max_reps`` /
    ``rel_spread`` band drives the rep count.

    Under an active :mod:`repro_torch.obs` capture the summary (reps /
    median / spread / convergence) is annotated on the enclosing span, or
    recorded as a ``tune.measure`` event when no span is open.
    """
    if reps is not None:
        reps = int(reps)
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        min_reps = max_reps = reps
    devices = _cuda_devices(args)

    def sync() -> None:
        for d in devices:
            torch.cuda.synchronize(d)

    f(*args)                                        # warm up
    sync()

    def sample() -> float:
        t0 = time.perf_counter()
        f(*args)
        sync()
        return time.perf_counter() - t0

    m = repetition_controller(sample, min_reps=min_reps,
                              max_reps=max_reps, rel_spread=rel_spread)
    if _obs.enabled():
        fields = {"measure_reps": m.reps,
                  "measure_seconds_median": m.seconds_median,
                  "measure_seconds_spread": m.seconds_spread,
                  "measure_converged": m.converged}
        if not _obs.annotate(**fields):
            _obs.event("tune.measure", cat="measure", **fields)
    return m


def measure_wall_time(f, *args, reps: int = 2) -> float:
    """Median seconds of exactly ``reps`` timed calls (warm-up excluded);
    ``reps`` must be ``>= 1``."""
    return measure(f, *args, reps=reps).seconds_median


def model_residual(modeled_s: float, measured_s: float) -> float:
    """Relative modeled-vs-measured residual of one row:
    ``(measured - modeled) / measured``. 0: the model explains the measured
    median exactly; near 1: the model is far optimistic; negative: the code
    beat the model. NaN when the measured time is not positive."""
    measured_s = float(measured_s)
    if not measured_s > 0 or not math.isfinite(measured_s):
        return float("nan")
    return (measured_s - float(modeled_s)) / measured_s
