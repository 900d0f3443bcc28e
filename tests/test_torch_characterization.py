"""repro_torch.core.characterization against repro.core.characterization:
each routine's per-pipe (N_I, N_H, gamma, t_p, t_o), flops and critical
path, its hazard ratios and eq.-7 optima (closed form and integer), and the
section-4 table, at several sizes and options and against several
machines' FPU specs. Integers exact, floats rel 1e-12; the integer optima
with the reference's pipeline model in float64 (its x64 mode), as the
port's model computes."""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro import arch as jarch
from repro.core import characterization as jch
from repro_torch import arch as tarch
from repro_torch.core import characterization as tch

RTOL = 1e-12
MACHINES = (None, "tpu-like", "cpu-host")


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _close(got, want):
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    elif isinstance(want, int) and isinstance(got, int):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=RTOL, abs=0.0)


def _same_profile(t, j):
    assert t.name == j.name
    _close(t.flops, j.flops)
    _close(t.critical_path, j.critical_path)
    assert list(t.pipes) == list(j.pipes)
    for k, jp in j.pipes.items():
        tp = dataclasses.asdict(t.pipes[k])
        for field, want in dataclasses.asdict(jp).items():
            _close(tp[field], want)
    for k, want in j.hazard_ratios().items():
        _close(t.hazard_ratios()[k], want)
    got = t.popt_closed_form()
    assert list(got) == list(j.popt_closed_form())
    for k, want in j.popt_closed_form().items():
        assert got[k] == want or (math.isinf(got[k]) and math.isinf(want))
    assert t.optimal_depths() == j.optimal_depths()
    assert t.optimal_depths(p_min=2, p_max=24) == \
        j.optimal_depths(p_min=2, p_max=24)


def _fpus(machine):
    if machine is None:
        return None, None
    return tarch.get(machine).fpu, jarch.get(machine).fpu


def test_technology_constants_equal_reference():
    assert tch.T_O == jch.T_O and tch.T_P == jch.T_P
    assert sorted(tch.ROUTINES) == sorted(jch.ROUTINES)


@pytest.mark.parametrize("n", [2, 3, 100, 4096])
@pytest.mark.parametrize("schedule,acc", [("tree", 1), ("sequential", 1),
                                          ("strided", 1), ("strided", 8)])
@pytest.mark.parametrize("machine", MACHINES)
def test_ddot_profile_matches_reference(x64, n, schedule, acc, machine):
    tf, jf = _fpus(machine)
    _same_profile(tch.characterize_ddot(n, schedule, acc, fpu=tf),
                  jch.characterize_ddot(n, schedule, acc, fpu=jf))


@pytest.mark.parametrize("m,n", [(1, 2), (7, 33), (100, 100)])
@pytest.mark.parametrize("schedule", ["tree", "sequential", "strided"])
def test_dgemv_profile_matches_reference(x64, m, n, schedule):
    _same_profile(tch.characterize_dgemv(m, n, schedule, 4),
                  jch.characterize_dgemv(m, n, schedule, 4))


@pytest.mark.parametrize("mnk", [(1, 1, 1), (3, 5, 2), (100, 100, 100)])
@pytest.mark.parametrize("unroll", [1, 4, 8])
@pytest.mark.parametrize("machine", MACHINES)
def test_dgemm_profile_matches_reference(x64, mnk, unroll, machine):
    tf, jf = _fpus(machine)
    _same_profile(tch.characterize_dgemm(*mnk, unroll=unroll, fpu=tf),
                  jch.characterize_dgemm(*mnk, unroll=unroll, fpu=jf))


@pytest.mark.parametrize("routine", ["dgeqrf", "dgetrf", "dpotrf"])
@pytest.mark.parametrize("n", [1, 7, 48, 100])
@pytest.mark.parametrize("machine", MACHINES)
def test_lapack_profiles_match_reference(x64, routine, n, machine):
    tf, jf = _fpus(machine)
    _same_profile(tch.ROUTINES[routine](n, unroll=4, fpu=tf),
                  jch.ROUTINES[routine](n, unroll=4, fpu=jf))


@pytest.mark.parametrize("n", [10, 100])
def test_characterization_table_matches_reference(x64, n):
    t, j = tch.characterization_table(n), jch.characterization_table(n)
    assert list(t) == list(j)
    for name, row in j.items():
        assert list(t[name]) == list(row)
        for key, want in row.items():
            _close(t[name][key], want)


@pytest.mark.parametrize("call", [lambda m: m.characterize_ddot(1),
                                  lambda m: m.characterize_ddot(8, "zigzag")])
def test_bad_arguments_raise_as_reference(call):
    for mod in (jch, tch):
        with pytest.raises(ValueError):
            call(mod)
