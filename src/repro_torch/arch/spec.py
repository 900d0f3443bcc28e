"""Machine/FPU architecture specs - the paper's design space as data.

Port of ``repro.arch.spec``: the same frozen value types with the same
fields and the same JSON schema (version 1), so a spec file written by
the JAX package loads here unchanged and vice versa.

``FPUSpec``
    Per-op-class pipeline depths plus the eq.-2 technology constants
    (``t_p``, ``t_o``, ``gamma``) and the accumulator bookkeeping cost;
    ``pipe_params`` / ``tpi`` / ``p_opt`` feed
    :mod:`repro_torch.core.pipeline_model`.
``MemorySpec``
    HBM / on-chip scratch / inter-chip bandwidths and capacities, plus the
    per grid-step software-pipeline fill cost the planners price.
``PEGeometry``
    Matrix-unit edge, vector-unit shape, register budget and peak FLOP
    rate (clock and vector peak are derived).
``PowerAreaSpec``
    Per-op-class dynamic energy, HBM access energy, static power and die
    area - the paper's Gflops/W and Gflops/mm^2 axes.
``MachineSpec``
    The frozen composition of the four, with a name and a native compute
    dtype (the planners' dtype default).

Each field also has a GPU meaning, which the ``"h100"`` spec of
:mod:`repro_torch.arch.registry` uses: ``vmem_bytes`` is the shared memory
one CTA may use, ``mxu`` the MMA granule the planner aligns blocks to,
``sublane`` x ``lane`` the FP32 lanes of one SM (warp schedulers x warp
width), ``vreg_budget`` the registers one thread may hold, ``ici_bw`` the
NVLink rate each way, ``pipeline_fill_s`` the cost of one eager kernel
launch, ``depths`` each op class's dependent-issue latency in SM cycles.
Two fields have no counterpart in the reference and are optional:
``PEGeometry.sm_count`` (SMs the planner fills with CTAs; set only for a
GPU, it is what makes :mod:`repro_torch.core.codesign` price CTA tiles)
and ``PEGeometry.clock_hz`` (the SM clock; else derived from the peak).
A spec that leaves them ``None`` writes the reference's JSON byte for
byte.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

from repro_torch import _dtype

# The paper's four floating-point instruction classes, K = {M, A, S, D}.
OP_CLASSES = ("mul", "add", "div", "sqrt")

SCHEMA_VERSION = 1

# PEGeometry fields the reference lacks: written only when set, so a spec
# without them writes the reference's JSON byte for byte
PORT_ONLY_PE_FIELDS = ("sm_count", "clock_hz")


def _class_map(value, name: str, cast) -> Dict[str, Any]:
    """Validate/normalize a per-op-class mapping (exactly OP_CLASSES keys)."""
    if not isinstance(value, Mapping):
        raise ValueError(f"{name} must be a mapping over {OP_CLASSES}, "
                         f"got {type(value).__name__}")
    got = set(value)
    if got != set(OP_CLASSES):
        raise ValueError(f"{name} must have exactly the op classes "
                         f"{OP_CLASSES}; got {sorted(got)}")
    return {k: cast(value[k]) for k in OP_CLASSES}


@dataclasses.dataclass(frozen=True)
class FPUSpec:
    """Floating-point unit micro-architecture (paper sections 3-4)."""

    depths: Mapping[str, int]
    t_p: Mapping[str, float]
    t_o: float
    gamma: Mapping[str, float]
    acc_overhead: float = 0.75

    def __post_init__(self):
        object.__setattr__(self, "depths",
                           _class_map(self.depths, "depths", int))
        object.__setattr__(self, "t_p", _class_map(self.t_p, "t_p", float))
        object.__setattr__(self, "gamma",
                           _class_map(self.gamma, "gamma", float))
        if not float(self.t_o) > 0:
            raise ValueError(f"t_o must be positive, got {self.t_o!r}")
        for k, d in self.depths.items():
            if d < 1:
                raise ValueError(f"depths[{k!r}] must be >= 1, got {d}")

    def pipe_params(self, op_class: str, n_i: float, n_h: float):
        """A :class:`repro_torch.core.pipeline_model.PipeParams` for one op
        class of this FPU at a given workload census."""
        from repro_torch.core.pipeline_model import PipeParams
        return PipeParams(n_i=float(n_i), n_h=float(n_h),
                          gamma=self.gamma[op_class],
                          t_p=self.t_p[op_class], t_o=self.t_o)

    def tpi(self, op_class: str, p, n_i: float, n_h: float):
        """Paper eq.-2 time-per-instruction of one pipe at depth ``p``."""
        from repro_torch.core import pipeline_model
        return pipeline_model.tpi(p, n_i=float(n_i), n_h=float(n_h),
                                  gamma=self.gamma[op_class],
                                  t_p=self.t_p[op_class], t_o=self.t_o)

    def p_opt(self, op_class: str, n_i: float, n_h: float) -> float:
        """Paper eq.-3 closed-form optimal depth for one op class (+inf
        for hazard-free streams, the multiplier's flat curve)."""
        from repro_torch.core import pipeline_model
        return float(pipeline_model.p_opt(
            n_i=float(n_i), n_h=float(n_h), gamma=self.gamma[op_class],
            t_p=self.t_p[op_class], t_o=self.t_o))

    @property
    def add_latency(self) -> int:
        """Dependent-add chain latency in cycles (accumulator count U ~
        this latency, paper eq. 3)."""
        return self.depths["add"]

    def cycle_time(self, depths: Optional[Mapping[str, int]] = None,
                   used=OP_CLASSES) -> float:
        """Clock period = slowest pipe stage + latch overhead."""
        p = dict(self.depths)
        if depths:
            p.update({k: int(v) for k, v in depths.items()})
        stage = max(self.t_p[u] / p[u] for u in used) if used else 1.0
        return stage + self.t_o


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """Memory-hierarchy bandwidths and capacities the planners price."""

    hbm_bw: float                 # bytes/s per chip
    vmem_bytes: int               # usable on-chip scratch budget
    ici_bw: float                 # bytes/s per inter-chip link
    hbm_bytes: Optional[int] = None   # HBM capacity (None = unmodeled)
    pipeline_fill_s: float = 2e-6

    def __post_init__(self):
        for f in ("hbm_bw", "vmem_bytes", "ici_bw"):
            if not float(getattr(self, f)) > 0:
                raise ValueError(f"{f} must be positive, "
                                 f"got {getattr(self, f)!r}")


@dataclasses.dataclass(frozen=True)
class PEGeometry:
    """Compute-resource structure of the processing element array."""

    mxu: int
    sublane: int
    lane: int
    vreg_budget: int              # architectural vector registers
    peak_flops: float             # per chip, at the native dtype
    sm_count: Optional[int] = None    # GPU only: streaming multiprocessors
    clock_hz: Optional[float] = None  # GPU only: the SM clock

    def __post_init__(self):
        for f in ("mxu", "sublane", "lane", "vreg_budget", "peak_flops"):
            if not float(getattr(self, f)) > 0:
                raise ValueError(f"{f} must be positive, "
                                 f"got {getattr(self, f)!r}")
        for f in PORT_ONLY_PE_FIELDS:
            v = getattr(self, f)
            if v is not None and not float(v) > 0:
                raise ValueError(f"{f} must be positive or None, got {v!r}")

    @property
    def mxu_clock(self) -> float:
        """Cycles/s: ``clock_hz`` where set, else implied by the peak rate
        (2*mxu^2 flops per cycle)."""
        if self.clock_hz is not None:
            return float(self.clock_hz)
        return self.peak_flops / (2 * self.mxu * self.mxu)

    @property
    def vpu_flops(self) -> float:
        """Vector (non-matrix) peak: one lane-grid op per cycle, on each
        of ``sm_count`` SMs where set."""
        return self.mxu_clock * self.sublane * self.lane \
            * (self.sm_count or 1)


@dataclasses.dataclass(frozen=True)
class PowerAreaSpec:
    """Energy/area model: the paper's Gflops/W and Gflops/mm^2 axes."""

    pj_per_flop: Mapping[str, float]
    pj_per_byte_hbm: float        # HBM access energy per byte
    static_w: float               # leakage + always-on power
    area_mm2: float               # die area

    def __post_init__(self):
        object.__setattr__(self, "pj_per_flop",
                           _class_map(self.pj_per_flop, "pj_per_flop", float))
        for f in ("pj_per_byte_hbm", "static_w", "area_mm2"):
            if float(getattr(self, f)) < 0:
                raise ValueError(f"{f} must be >= 0, "
                                 f"got {getattr(self, f)!r}")
        if not float(self.area_mm2) > 0:
            raise ValueError(f"area_mm2 must be positive, "
                             f"got {self.area_mm2!r}")

    def flop_energy_pj(self, mix: Optional[Mapping[str, float]] = None) -> float:
        """Weighted pJ/flop for a FLOP mix (fractions per op class);
        default is the FMA mix {mul: 0.5, add: 0.5}."""
        mix = dict(mix) if mix else {"mul": 0.5, "add": 0.5}
        total = sum(mix.values())
        if not total > 0:
            raise ValueError("flop mix must have positive total weight")
        return sum(self.pj_per_flop[k] * w for k, w in mix.items()) / total


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """A complete machine: FPU + memory + PE geometry + power/area."""

    name: str
    fpu: FPUSpec
    memory: MemorySpec
    pe: PEGeometry
    power_area: PowerAreaSpec
    native_dtype: str = "float32"

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"machine name must be a non-empty string, "
                             f"got {self.name!r}")
        _dtype.to_torch(self.native_dtype)      # ValueError on unknown

    def dtype_bytes(self, dtype=None) -> int:
        """Itemsize of ``dtype``, defaulting to the native compute dtype."""
        return _dtype.itemsize(dtype if dtype is not None
                               else self.native_dtype)

    @property
    def peak_gflops(self) -> float:
        return self.pe.peak_flops / 1e9

    def watts(self, gflops: float, hbm_bytes_per_s: float = 0.0,
              mix: Optional[Mapping[str, float]] = None) -> float:
        """Modeled power at a sustained FLOP rate + HBM traffic rate."""
        dynamic = gflops * self.power_area.flop_energy_pj(mix) * 1e-3
        hbm = hbm_bytes_per_s * self.power_area.pj_per_byte_hbm * 1e-12
        return dynamic + hbm + self.power_area.static_w

    def gflops_per_w(self, gflops: float, hbm_bytes_per_s: float = 0.0,
                     mix: Optional[Mapping[str, float]] = None) -> float:
        """The paper's energy-efficiency score at an achieved rate."""
        w = self.watts(gflops, hbm_bytes_per_s, mix)
        return gflops / w if w > 0 else float("inf")

    def gflops_per_mm2(self, gflops: float) -> float:
        """The paper's area-efficiency score at an achieved rate."""
        return gflops / self.power_area.area_mm2

    def peak_gflops_per_w(self) -> float:
        return self.gflops_per_w(self.peak_gflops)

    def peak_gflops_per_mm2(self) -> float:
        return self.gflops_per_mm2(self.peak_gflops)

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "name": self.name,
            "native_dtype": self.native_dtype,
            "fpu": {"depths": dict(self.fpu.depths),
                    "t_p": dict(self.fpu.t_p), "t_o": self.fpu.t_o,
                    "gamma": dict(self.fpu.gamma),
                    "acc_overhead": self.fpu.acc_overhead},
            "memory": dataclasses.asdict(self.memory),
            "pe": {k: v for k, v in dataclasses.asdict(self.pe).items()
                   if not (k in PORT_ONLY_PE_FIELDS and v is None)},
            "power_area": {"pj_per_flop": dict(self.power_area.pj_per_flop),
                           "pj_per_byte_hbm": self.power_area.pj_per_byte_hbm,
                           "static_w": self.power_area.static_w,
                           "area_mm2": self.power_area.area_mm2},
        }

    @classmethod
    def from_json(cls, blob: Mapping[str, Any]) -> "MachineSpec":
        """Rebuild a spec from :meth:`to_json` output; ``ValueError`` on
        any malformed input (wrong schema, missing section, bad field)."""
        if not isinstance(blob, Mapping):
            raise ValueError(f"machine spec must be a JSON object, "
                             f"got {type(blob).__name__}")
        if blob.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"machine spec schema mismatch: want "
                             f"{SCHEMA_VERSION}, got {blob.get('schema')!r}")
        try:
            return cls(
                name=blob["name"],
                native_dtype=blob.get("native_dtype", "float32"),
                fpu=FPUSpec(**dict(blob["fpu"])),
                memory=MemorySpec(**dict(blob["memory"])),
                pe=PEGeometry(**dict(blob["pe"])),
                power_area=PowerAreaSpec(**dict(blob["power_area"])),
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed machine spec: {e!r}") from e

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "MachineSpec":
        """Load a spec from a JSON file; ``ValueError`` on a corrupt file,
        ``OSError`` on a missing or unreadable one."""
        with open(path) as f:
            try:
                blob = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"corrupt machine spec at {path}: {e}") from e
        return cls.from_json(blob)
