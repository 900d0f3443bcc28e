"""Cycle-level PE + APE simulator (paper section 5, fig. 11; port of
``repro.core.pe``).

The paper's Processing Element is a scalar, in-order, single-issue core with
four floating-point units of *configurable pipeline depth* (the experimental
knob), a register file preloaded by an Auxiliary PE (steps 1-2 of the paper's
operating procedure - so compute streams see RF-resident operands).

This simulator executes the SSA instruction streams of
:mod:`repro_torch.core.isa` with an exact in-order stall-on-use scoreboard:

    issue[i] = max(issue[i-1] + 1, ready[src1[i]], ready[src2[i]])
    ready[i] = issue[i] + latency[opcode[i]]

latency is the unit's pipeline depth (units are fully pipelined; composite
ops: FMA = p_mul + p_add chained, DOT4 = p_mul + 2*p_add - a 4-multiplier
front feeding a 2-level adder tree, the paper's "4 multipliers and 3 adders
in a reconfigurable way").

All pipes share one clock whose cycle time is set by the slowest stage,
``max_u(t_p_u / p_u) + t_o`` - deeper pipes raise the clock, stalls cost
cycles: exactly the eq.-2 trade-off, but *measured* instead of modeled.

The reference's scoreboard is a jitted ``lax.scan``, ``vmap``ped over depth
configurations. Here it is B8, a hand-written kernel
(:mod:`repro_torch.kernels.pe_scoreboard`, ``csrc/pe_scoreboard.cu``): one
launch per :func:`simulate` and one per :func:`sweep` / :func:`sweep_joint`
(every depth configuration of the sweep in that launch), on the card unless
the caller passes ``device="cpu"``, which runs the kernel's plain version
(the same recurrence in Python; the CPU tests use it). Cycles and stalls
are the reference's, exactly, in int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch import arch as _arch
from repro_torch.arch import MachineSpec
from repro_torch.core import isa
from repro_torch.core.characterization import T_O, T_P
from repro_torch.kernels.pe_scoreboard import pe_scoreboard

# the paper's section-5 experimental optimum = the "paper-pe" machine's FPU
DEFAULT_DEPTHS = dict(_arch.get("paper-pe").fpu.depths)


def _fpu_of(machine):
    """The FPUSpec a simulation prices against (None = "paper-pe" - the
    historical DEFAULT_DEPTHS / characterization T_P / T_O constants)."""
    m = machine if machine is not None else _arch.get("paper-pe")
    return m.fpu


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.core.pe runs its scoreboard on "
                           "'cuda' by default and no CUDA device is "
                           "available; ask for the CPU with device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the PE scoreboard runs on cuda or cpu, not {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class PEResult:
    """One simulation outcome at one depth configuration."""

    name: str
    depths: Dict[str, int]
    n_instructions: int
    flops: int
    cycles: int
    stalls: int
    cycle_time: float            # in t_o-normalized time units
    frequency: float             # 1 / cycle_time

    @property
    def cpi(self) -> float:
        return self.cycles / max(self.n_instructions, 1)

    @property
    def tpi(self) -> float:
        """Time per instruction = CPI * cycle_time (the paper's TPI)."""
        return self.cpi * self.cycle_time

    @property
    def time(self) -> float:
        return self.cycles * self.cycle_time

    @property
    def flops_per_time(self) -> float:
        return self.flops / max(self.time, 1e-30)


def _latency_vector(depths: Mapping[str, int],
                    base: Mapping[str, int] = None) -> np.ndarray:
    p = {**(base or DEFAULT_DEPTHS), **{k: int(v) for k, v in depths.items()}}
    lat = np.zeros(isa.N_OPCODES, dtype=np.int32)
    lat[isa.NOP] = 1
    lat[isa.MUL] = p["mul"]
    lat[isa.ADD] = p["add"]
    lat[isa.DIV] = p["div"]
    lat[isa.SQRT] = p["sqrt"]
    lat[isa.FMA] = p["mul"] + p["add"]
    lat[isa.DOT4] = p["mul"] + 2 * p["add"]
    return lat


def cycle_time(depths: Mapping[str, int], used: Sequence[str] = ("mul", "add", "div", "sqrt"),
               t_o: float = T_O, t_p: Mapping[str, float] = None,
               base: Mapping[str, int] = None) -> float:
    """Clock period = slowest pipe stage + latch overhead (paper's equal-
    stage-time assumption across pipes, [18]). ``t_p``/``base`` default to
    the "paper-pe" technology constants / depths."""
    p = {**(base or DEFAULT_DEPTHS), **{k: int(v) for k, v in depths.items()}}
    tp = t_p or T_P
    stage = max(tp[u] / p[u] for u in used) if used else 1.0
    return stage + t_o


def _scoreboard(stream: isa.InstrStream, lats: Sequence[np.ndarray],
                device):
    """(cycles, stalls) lists, one entry per latency vector: one B8 launch
    on the card, its plain version on the CPU."""
    dev = _device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    cycles, stalls = pe_scoreboard(put(stream.opcode), put(stream.src1),
                                   put(stream.src2), put(np.stack(lats)))
    return cycles.tolist(), stalls.tolist()


def _results(stream: isa.InstrStream, cfgs, cycles, stalls, t_o, fpu):
    used = [k for k, v in stream.census().items() if v > 0]
    out = []
    for cfg, cy, st in zip(cfgs, cycles, stalls):
        ct = cycle_time(cfg, used=used or ("mul",), t_o=t_o, t_p=fpu.t_p,
                        base=fpu.depths)
        out.append(PEResult(stream.name, cfg, stream.n_instructions,
                            stream.flops, int(cy), int(st), ct, 1.0 / ct))
    return out


def simulate(stream: isa.InstrStream, depths: Mapping[str, int] | None = None,
             t_o: float = None,
             machine: MachineSpec | None = None,
             device="cuda") -> PEResult:
    """Run one stream at one depth configuration.

    ``machine`` supplies the base depths and technology constants
    (``None`` = the "paper-pe" spec, i.e. the historical defaults);
    explicit ``depths`` / ``t_o`` override it. ``device``: where the
    scoreboard runs (B8 on ``"cuda"``, its plain version on ``"cpu"``).
    """
    fpu = _fpu_of(machine)
    t_o = fpu.t_o if t_o is None else t_o
    depths = dict(fpu.depths, **(depths or {}))
    cycles, stalls = _scoreboard(
        stream, [_latency_vector(depths, base=fpu.depths)], device)
    return _results(stream, [depths], cycles, stalls, t_o, fpu)[0]


def sweep(stream: isa.InstrStream, unit: str, depth_values: Sequence[int],
          fixed: Mapping[str, int] | None = None, t_o: float = None,
          machine: MachineSpec | None = None, device="cuda"):
    """Depth sweep of one unit (figs 12-13): one scoreboard launch for all
    depths.

    Returns a list of PEResult, one per depth in ``depth_values``.
    ``machine`` supplies base depths + technology constants (``None`` =
    "paper-pe", the historical defaults); ``device`` as in
    :func:`simulate`.
    """
    return sweep_joint(stream, [unit], depth_values, fixed=fixed, t_o=t_o,
                       machine=machine, device=device)


def sweep_joint(stream: isa.InstrStream, units: Sequence[str],
                depth_values: Sequence[int],
                fixed: Mapping[str, int] | None = None, t_o: float = None,
                machine: MachineSpec | None = None,
                device="cuda"):
    """Sweep several units together at the same depth (fig. 12 sweeps adder
    and multiplier jointly; fig. 13 sqrt and divider). ``machine`` and
    ``device`` as in :func:`sweep`."""
    fpu = _fpu_of(machine)
    t_o = fpu.t_o if t_o is None else t_o
    fixed = dict(fpu.depths, **(fixed or {}))
    cfgs = []
    for d in depth_values:
        cfg = dict(fixed)
        for u in units:
            cfg[u] = int(d)
        cfgs.append(cfg)
    cycles, stalls = _scoreboard(
        stream, [_latency_vector(c, base=fpu.depths) for c in cfgs], device)
    return _results(stream, cfgs, cycles, stalls, t_o, fpu)


def best_depth(results: Sequence[PEResult], unit: str) -> int:
    """Depth minimizing measured TPI (time, not CPI - CPI alone is monotone
    in depth; the optimum only exists once the faster clock is credited)."""
    best = min(results, key=lambda r: r.tpi)
    return best.depths[unit]
