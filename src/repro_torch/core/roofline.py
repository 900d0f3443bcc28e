"""Three-term roofline of one traced step (port of ``repro.core.roofline``).

The dry run (:mod:`repro_torch.launch.dryrun`) traces one rank's step of
every (arch x shape x mesh) cell on fake tensors in a fake world, and this
module turns what the trace counted into the report:

    compute term    = flops            / peak FLOP/s of the machine
    memory term     = bytes            / HBM bandwidth of the machine
    collective term = collective_bytes / inter-chip bandwidth of the machine

All three inputs are per chip (per rank): the trace is one rank's program.
PyTorch compiles no HLO, so :func:`from_trace` takes the place of the
reference's ``from_compiled``: the flops, bytes and collective bytes come
from :class:`repro_torch.core.aten_cost.Cost` (a dispatch mode over every
aten op the step runs) and the peak memory from the same trace's live
storages.

:func:`collective_bytes` and :func:`_shape_bytes` read XLA's HLO text and
are kept as they are, since ``repro_torch.core`` exports
``collective_bytes`` by name as the reference does; nothing in the port
emits HLO. Rows are :class:`Roofline` values with the reference's fields;
:func:`save_json` / :func:`load_json` read and write the reference's
files, so either package reads the other's rows.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional

from repro_torch import arch as _arch

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_SHAPE_RE = re.compile(r"\b(pred|bf16|f16|f32|f64|f8e4m3fn|f8e5m2|s8|s16|s32|s64|u8|u16|u32|u64)\[([\d,]*)\]")
_DTYPE_BYTES = {"pred": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
                "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "s16": 2, "s32": 4,
                "s64": 8, "u8": 1, "u16": 2, "u32": 4, "u64": 8}
# op-kind position in an HLO line: "%name = <shape> <kind>(<operands>)...";
# the result type may be a tuple with spaces (async -start forms), hence the
# lazy any-match. "-done" forms never match (no '(' right after the kind).
_OP_RE = re.compile(
    r"=\s+.*?\s(" + "|".join(_COLLECTIVES) + r")(-start)?\(")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _operand_region(line: str, open_idx: int) -> str:
    """Balanced-paren scan from ``open_idx`` (the op-kind's '(')."""
    depth = 0
    for j in range(open_idx, len(line)):
        c = line[j]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return line[open_idx + 1:j]
    return line[open_idx + 1:]


_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([^\s=]+)\s*=\s*(.*)$")
_KIND_RE = re.compile(r"\s([a-z][\w-]*)\(")
_NAME_RE = re.compile(r"%([^\s,()]+)")


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum of *operand* bytes per collective kind across an HLO module.

    Optimized HLO prints operands by name only, so a per-computation symbol
    table (name -> result bytes) resolves the collective operands. Async
    ``-start`` forms are counted; ``-done`` forms skipped (they would
    double count).
    """
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    block = 0
    table: Dict[tuple, int] = {}
    pending = []                           # (kind, block, [operand names])
    for line in hlo_text.splitlines():
        stripped = line.rstrip()
        if stripped.endswith("{") and not line.startswith(" "):
            block += 1                     # new computation scope
        d = _DEF_RE.match(line)
        if not d:
            continue
        name, rest = d.group(1), d.group(2)
        km = _KIND_RE.search(" " + rest)
        # result-type segment = text before the op kind token
        seg = rest[: km.start() - 1] if km else rest
        table[(block, name)] = _shape_bytes(seg)
        m = _OP_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        region = _operand_region(line, m.end() - 1)  # m.end()-1 is the '('
        ops = _NAME_RE.findall(region)
        pending.append((kind, block, ops))
    for kind, blk, ops in pending:
        for op in ops:
            out[kind] += table.get((blk, op), 0)
    return out


@dataclasses.dataclass(frozen=True)
class Roofline:
    """One cell's roofline report (all terms in seconds per step)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # per chip (the traced rank's aten ops)
    hlo_bytes: float               # per chip (the fused-traffic model)
    coll_bytes: float              # per chip (sum over collectives)
    coll_breakdown: Dict[str, int]
    model_flops: float             # 6*N*D (train) or 2*N_active*tokens (serve), global
    bytes_per_device: float        # the rank's state and batch + peak extra live bytes
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    machine: Optional[str] = None  # registered machine name (None = default)

    def machine_spec(self):
        """The :class:`repro_torch.arch.MachineSpec` this report prices
        against. A machine name not registered in this process degrades to
        the default machine instead of raising: loaded reports must always
        be readable."""
        try:
            return _arch.get(self.machine or _arch.DEFAULT_MACHINE)
        except ValueError:
            return _arch.get(_arch.DEFAULT_MACHINE)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.machine_spec().pe.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.machine_spec().memory.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.machine_spec().memory.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Max-term bound (perfect overlap of the other two)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / traced flops (global): < 1 means remat or
        redundant work, > 1 that the step did less than the model count."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound at this schedule: useful flops / (chips *
        peak * step_time)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (
            self.chips * self.machine_spec().pe.peak_flops * t)

    @property
    def modeled_gflops_per_w(self) -> float:
        """The paper's energy score at this schedule: per-chip useful
        Gflop/s over the machine's modeled power (FLOP + HBM energy +
        static)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        gflops = self.model_flops / (self.chips * t) / 1e9
        return self.machine_spec().gflops_per_w(
            gflops, hbm_bytes_per_s=self.hlo_bytes / t)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flop_ratio=self.useful_flop_ratio,
                 roofline_fraction=self.roofline_fraction,
                 step_time_s=self.step_time_s,
                 machine=self.machine or _arch.DEFAULT_MACHINE,
                 gflops_per_w=self.modeled_gflops_per_w)
        return d


def from_trace(arch: str, shape: str, mesh_name: str, chips: int, cost,
               model_flops: float, bytes_per_device: float,
               extra: Optional[Dict[str, float]] = None,
               machine: Optional[str] = None) -> Roofline:
    """A row from one rank's traced step: ``cost`` is its
    :class:`repro_torch.core.aten_cost.Cost`, ``bytes_per_device`` its
    peak memory (:func:`repro_torch.core.aten_cost.peak_bytes`). The
    memory term reads the fused-traffic bytes (``cost.bytes_fused``), as
    the reference's trip-aware row does; the every-op upper bound is kept
    in ``extra["bytes_unfused"]``."""
    extra = dict(extra or {})
    extra["bytes_unfused"] = float(cost.bytes)
    coll = {k: int(v) for k, v in cost.coll.items()}
    for k in _COLLECTIVES:
        coll.setdefault(k, 0)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=float(cost.flops),
                    hlo_bytes=float(cost.bytes_fused),
                    coll_bytes=float(sum(coll.values())),
                    coll_breakdown=coll, model_flops=model_flops,
                    bytes_per_device=float(bytes_per_device), extra=extra,
                    machine=machine)


def advice(r: Roofline) -> str:
    """One sentence on what would move the dominant term down."""
    if r.dominant == "compute":
        if r.useful_flop_ratio < 0.6:
            return ("compute-bound with low useful-flop ratio "
                    f"({r.useful_flop_ratio:.2f}): cut remat recompute or "
                    "redundant einsum transposes before touching sharding.")
        return ("compute-bound near the useful-flop floor: only weaker remat, "
                "lower-precision matmuls, or more chips move this term.")
    if r.dominant == "memory":
        return ("HBM-bound: raise arithmetic intensity - larger fused blocks, "
                "bf16 (not fp32) residents, fewer activation round-trips "
                "(fuse norms/activations into the matmul epilogue).")
    return ("collective-bound: reshard to shrink the traffic (e.g. move the "
            "sharded axis so the big all-gather becomes a reduce-scatter of "
            "the small side), overlap collectives with per-layer compute, or "
            "quantize the gradient all-reduce.")


def save_json(path: str, rooflines) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in rooflines], f, indent=1)


def load_json(path: str):
    with open(path) as f:
        rows = json.load(f)
    out = []
    for d in rows:
        keep = {k: d[k] for k in ("arch", "shape", "mesh", "chips", "hlo_flops",
                                  "hlo_bytes", "coll_bytes", "coll_breakdown",
                                  "model_flops", "bytes_per_device", "extra")}
        keep["machine"] = d.get("machine")      # pre-arch files resolve too
        out.append(Roofline(**keep))
    return out
