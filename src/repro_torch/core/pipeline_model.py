"""The paper's analytical pipeline model (port of ``repro.core.pipeline_model``).

The Hartstein-Puzak time-per-instruction (TPI) model the paper builds on,
one pipe per floating-point operation class (multiply / add / sqrt /
divide), and the closed-form optimal pipeline depth (paper eq. 2 and 3)::

    T / N_I = (t_o + gamma * N_H * t_p / N_I)      # depth-independent
            + (t_p / p)                            # ~ 1/p  (busy time)
            + (gamma * N_H * t_o * p / N_I)        # ~ p    (hazard penalty)

    p_opt^2 = N_I * t_p / (gamma * N_H * t_o)      # eq. 3

Every function takes Python floats, numpy arrays or torch tensors and
broadcasts; the results are torch tensors. :func:`tpi` computes in
float64 (the reference's x64 mode); :func:`p_opt` casts ``n_i`` and
``n_h`` to float32 as the reference does, so the two packages return the
same values.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

# The paper's four floating-point instruction classes, K = {M, A, S, D}.
OP_CLASSES = ("mul", "add", "sqrt", "div")


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class PipeParams:
    """Parameters of one pipe (one FP operation class) in the model.

    Attributes:
      n_i:   N_iI, number of instructions issued to this pipe.
      n_h:   N_iH, number of (dependency) hazards seen by this pipe.
      gamma: mean fraction of the total pipe delay exposed per hazard.
      t_p:   total latch-free logic delay of the unit.
      t_o:   per-stage latch overhead for the technology node.
    """

    n_i: float
    n_h: float
    gamma: float
    t_p: float = 1.0
    t_o: float = 0.05

    def replace(self, **kw) -> "PipeParams":
        return dataclasses.replace(self, **kw)


def tpi(p, *, n_i, n_h, gamma, t_p=1.0, t_o=0.05) -> torch.Tensor:
    """Time-per-instruction of one pipe at depth ``p`` (paper eq. 2).

    Every argument may be an array; standard broadcasting applies.
    ``n_h == 0`` degrades to the hazard-free ``t_o + t_p / p`` curve.
    """
    p, n_i, n_h = _f64(p), _f64(n_i), _f64(n_h)
    hazard_rate = torch.where(n_i > 0, n_h / torch.clamp(n_i, min=1),
                              _f64(0.0))
    fixed = t_o + gamma * hazard_rate * t_p
    busy = t_p / p
    penalty = gamma * hazard_rate * t_o * p
    return fixed + busy + penalty


def tpi_pipe(p, params: PipeParams) -> torch.Tensor:
    return tpi(p, n_i=params.n_i, n_h=params.n_h, gamma=params.gamma,
               t_p=params.t_p, t_o=params.t_o)


def total_time(p, params: PipeParams) -> torch.Tensor:
    """Total pipe time T = TPI * N_I (paper eq. 1 split into busy/non-busy)."""
    return tpi_pipe(p, params) * params.n_i


def p_opt(*, n_i, n_h, gamma, t_p=1.0, t_o=0.05) -> torch.Tensor:
    """Closed-form optimal pipeline depth (paper eq. 3 / eq. 7); +inf for
    hazard-free streams (N_H == 0), the multiplier's flat curve."""
    n_h = torch.as_tensor(n_h, dtype=torch.float32)
    n_i = torch.as_tensor(n_i, dtype=torch.float32)
    denom = gamma * n_h * t_o
    return torch.where(denom > 0,
                       torch.sqrt(n_i * t_p / torch.clamp(denom, min=1e-30)),
                       torch.tensor(float("inf"), dtype=torch.float32))


def p_opt_pipe(params: PipeParams) -> torch.Tensor:
    return p_opt(n_i=params.n_i, n_h=params.n_h, gamma=params.gamma,
                 t_p=params.t_p, t_o=params.t_o)


def p_opt_int(params: PipeParams, p_min: int = 1, p_max: int = 64) -> int:
    """Best integer depth in [p_min, p_max] by direct evaluation of eq. 2
    (for hazard-free pipes the deepest allowed depth)."""
    grid = torch.arange(p_min, p_max + 1)
    vals = tpi_pipe(grid, params)
    return int(grid[int(torch.argmin(vals))])


def tpi_multi(depths: Mapping[str, float], pipes: Mapping[str, PipeParams]):
    """Aggregate TPI over the four-pipe model (paper eq. 6): the pipe
    times summed against the global instruction count."""
    n_total = sum(float(p.n_i) for p in pipes.values())
    total = 0.0
    for name, pp in pipes.items():
        if pp.n_i <= 0:
            continue
        total = total + total_time(depths[name], pp)
    return total / max(n_total, 1.0)


def throughput(depths: Mapping[str, float], pipes: Mapping[str, PipeParams]):
    """Stall-free throughput G = sum_i 1/T_i of the k-pipe machine."""
    g = 0.0
    for name, pp in pipes.items():
        stage_time = pp.t_p / depths[name] + pp.t_o
        g = g + 1.0 / stage_time
    return g


# ------------------------------ figure curves -------------------------------

def figure2_curves(p_values=(2, 4, 6, 8),
                   hazard_ratios=(0.1, 0.01, 0.001),
                   n_i_grid=None):
    """Fig. 2 - TPI vs workload size for fixed depths / hazard ratios:
    dict[(p, ratio)] -> (n_i_grid, tpi)."""
    if n_i_grid is None:
        n_i_grid = torch.logspace(2, 7, 64, dtype=torch.float64)
    n_i_grid = _f64(n_i_grid)
    return {(p, r): (n_i_grid, tpi(p, n_i=n_i_grid, n_h=r * n_i_grid,
                                   gamma=0.5))
            for p in p_values for r in hazard_ratios}


def figure3_curves(hazard_ratios=(0.1, 0.01, 0.001, 0.2, 0.4, 0.6, 0.8),
                   p_grid=None, n_i=1e6):
    """Fig. 3 - TPI vs pipeline depth for varying hazard ratios."""
    if p_grid is None:
        p_grid = torch.arange(1, 41)
    return {r: (p_grid, tpi(p_grid, n_i=n_i, n_h=r * n_i, gamma=0.5))
            for r in hazard_ratios}


def figure4_curves(gammas=(0.1, 0.2, 0.4, 0.6, 0.8), p_grid=None,
                   n_i=1e6, hazard_ratio=0.01):
    """Fig. 4 - TPI vs pipeline depth for varying gamma."""
    if p_grid is None:
        p_grid = torch.arange(1, 41)
    return {g: (p_grid, tpi(p_grid, n_i=n_i, n_h=hazard_ratio * n_i,
                            gamma=g))
            for g in gammas}
