"""Synthesis-level power/area model - reproduces the paper's Tables 1 and 2
(port of ``repro.core.synthesis``).

The paper synthesizes its enhanced PE (4 multipliers + 3 adders reconfigured
behind a DOT4 instruction, 16 KB dual-ported SRAM) and compares against the
LAP-PE of Pedram et al. [2][5][21] at four operating points. Table 1 gives
area and power; Table 2 derives GFlops/mm^2 and GFlops/W.

This module encodes the published operating points, *derives* Table 2 from
Table 1 (GFlops = flops-per-cycle x frequency; LAP-PE retires an FMAC = 2
flops/cycle, the PE retires a DOT4 = 7 flops/cycle), checks the derivation
against the published numbers, and fits a dynamic+leakage power model so the
comparison extends to any frequency:

    P(f) = c_dyn * f * V(f)^2 + P_leak,   V(f) = v0 + v1 * f   (DVFS line)

It also evaluates the abstract's headline claims (1.1-1.5x GFlops/W,
1.9-2.1x GFlops/mm^2); the actual Table-2 GFlops/W ratios span 0.95x-1.66x,
a paper-internal discrepancy.

Pure host arithmetic: Python floats and one numpy least-squares fit, the
same operations in the same order as the reference, so every number equals
the reference's (``tests/test_torch_synthesis.py``). Nothing here runs on
the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

FLOPS_PER_CYCLE = {"lap-pe": 2.0, "pe": 7.0}   # FMAC vs DOT4


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One Table-1 row. Powers in mW, area in mm^2, speed in GHz."""

    design: str
    speed_ghz: float
    area_mm2: float
    mem_mw: float
    fmac_mw: float
    total_mw: float

    @property
    def gflops(self) -> float:
        return FLOPS_PER_CYCLE[self.design] * self.speed_ghz

    @property
    def gflops_per_mm2(self) -> float:
        return self.gflops / self.area_mm2

    @property
    def gflops_per_watt(self) -> float:
        return self.gflops / (self.total_mw * 1e-3)


# Paper Table 1 (16 KB dual-ported SRAM, double precision).
TABLE1: List[OperatingPoint] = [
    OperatingPoint("lap-pe", 1.81, 0.181, 13.25, 105.5, 118.7),
    OperatingPoint("lap-pe", 0.95, 0.174, 6.95, 31.0, 38.0),
    OperatingPoint("lap-pe", 0.33, 0.167, 2.41, 6.0, 8.4),
    OperatingPoint("lap-pe", 0.20, 0.169, 1.46, 3.4, 4.8),
    OperatingPoint("pe", 1.81, 0.301, 26.50, 422.0, 448.5),
    OperatingPoint("pe", 0.95, 0.280, 13.90, 124.0, 137.9),
    OperatingPoint("pe", 0.33, 0.273, 4.82, 24.0, 28.82),
    OperatingPoint("pe", 0.20, 0.275, 2.92, 13.6, 16.5),
]

# Paper Table 2 (published, for cross-checking the derivation).
TABLE2_PUBLISHED = {
    # speed: (lap_gflops_mm2, lap_gflops_w, pe_gflops_mm2, pe_gflops_w)
    1.81: (19.92, 29.7, 42.09, 28.24),
    0.95: (10.92, 46.4, 23.75, 48.54),
    0.33: (3.95, 57.8, 8.46, 82.5),
    0.20: (2.37, 51.1, 5.09, 84.84),
}


def derive_table2() -> Dict[float, Dict[str, float]]:
    """Table 2 derived from Table 1 + flops/cycle. Keys are speeds in GHz."""
    out: Dict[float, Dict[str, float]] = {}
    for op in TABLE1:
        row = out.setdefault(op.speed_ghz, {})
        row[f"{op.design}_gflops_mm2"] = op.gflops_per_mm2
        row[f"{op.design}_gflops_w"] = op.gflops_per_watt
    return out


def efficiency_ratios() -> Dict[str, Dict[float, float]]:
    """PE : LAP-PE ratios per operating point (the abstract's claims)."""
    t2 = derive_table2()
    area = {s: r["pe_gflops_mm2"] / r["lap-pe_gflops_mm2"] for s, r in t2.items()}
    watt = {s: r["pe_gflops_w"] / r["lap-pe_gflops_w"] for s, r in t2.items()}
    return {"gflops_per_mm2": area, "gflops_per_watt": watt}


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """P(f) = c_dyn * f * (v0 + v1 f)^2 + p_leak, least-squares fit."""

    design: str
    c_dyn: float
    v0: float
    v1: float
    p_leak: float

    def power_mw(self, f_ghz: float) -> float:
        v = self.v0 + self.v1 * f_ghz
        return self.c_dyn * f_ghz * v * v + self.p_leak

    def gflops_per_watt(self, f_ghz: float) -> float:
        return FLOPS_PER_CYCLE[self.design] * f_ghz / (self.power_mw(f_ghz) * 1e-3)


def fit_power_model(design: str) -> PowerModel:
    """Fit the DVFS model to the design's Table-1 points.

    With the voltage line fixed to a typical 28nm DVFS range
    (0.6 V at idle-clock to ~1.0 V at max), c_dyn and p_leak are a linear
    least-squares fit - two parameters, four points.
    """
    pts = [p for p in TABLE1 if p.design == design]
    f = np.array([p.speed_ghz for p in pts])
    p_tot = np.array([p.total_mw for p in pts])
    fmax = f.max()
    v0, v1 = 0.6, 0.4 / fmax          # V(fmax) = 1.0
    basis = f * (v0 + v1 * f) ** 2
    A = np.stack([basis, np.ones_like(f)], axis=1)
    (c_dyn, p_leak), *_ = np.linalg.lstsq(A, p_tot, rcond=None)
    return PowerModel(design, float(c_dyn), v0, v1, float(max(p_leak, 0.0)))


def energy_per_flop_pj(design: str, f_ghz: float) -> float:
    """Model-predicted energy per double-precision flop in picojoules."""
    m = fit_power_model(design)
    watts = m.power_mw(f_ghz) * 1e-3
    flops_per_s = FLOPS_PER_CYCLE[design] * f_ghz * 1e9
    return watts / flops_per_s * 1e12


def check_table2(tol: float = 0.06) -> Dict[str, Dict[str, float]]:
    """Compare our derived Table 2 against the published one.

    Both GFlops/mm^2 columns and the PE GFlops/W column derive from Table 1
    exactly (within rounding; ``tol`` = 6%) and are *asserted*. The LAP-PE
    GFlops/W column below 0.95 GHz does **not** follow from the paper's own
    Table 1 (e.g. 2 x 0.33 GFlops / 8.4 mW = 78.6, published 57.8) - a
    paper-internal inconsistency, presumably power numbers taken from Pedram
    et al. directly. Those cells are returned under ``"discrepant"``
    rather than force-fitted.
    """
    derived = derive_table2()
    checked: Dict[str, float] = {}
    discrepant: Dict[str, float] = {}
    for speed, (lm, lw, pm, pw) in TABLE2_PUBLISHED.items():
        d = derived[speed]
        checked[f"lap_mm2@{speed}"] = abs(d["lap-pe_gflops_mm2"] - lm) / lm
        checked[f"pe_mm2@{speed}"] = abs(d["pe_gflops_mm2"] - pm) / pm
        checked[f"pe_w@{speed}"] = abs(d["pe_gflops_w"] - pw) / pw
        lap_w_err = abs(d["lap-pe_gflops_w"] - lw) / lw
        (checked if lap_w_err <= tol else discrepant)[f"lap_w@{speed}"] = lap_w_err
    worst = max(checked.values())
    if worst > tol:
        bad = {k: v for k, v in checked.items() if v > tol}
        raise AssertionError(f"Table 2 derivation off beyond {tol:.0%}: {bad}")
    return {"checked": checked, "discrepant": discrepant}
