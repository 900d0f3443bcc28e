"""repro_torch.core.synthesis against repro.core.synthesis: the paper's
Table 1 operating points field for field, Table 2 derived from them, the
PE : LAP-PE ratios, the fitted DVFS power model, energy per flop and the
Table 2 check (its checked and discrepant cells, and its refusal below a
tolerance). Pure host arithmetic on both sides in the same order: floats
rel 1e-12."""
import dataclasses

import pytest

from repro.core import synthesis as jsyn
from repro_torch.core import synthesis as tsyn

RTOL = 1e-12
DESIGNS = ("lap-pe", "pe")


def _close_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close_tree(got[k], want[k])
    else:
        assert got == pytest.approx(want, rel=RTOL, abs=0.0)


def test_tables_equal_reference():
    assert tsyn.FLOPS_PER_CYCLE == jsyn.FLOPS_PER_CYCLE
    assert [dataclasses.asdict(p) for p in tsyn.TABLE1] == \
        [dataclasses.asdict(p) for p in jsyn.TABLE1]
    assert tsyn.TABLE2_PUBLISHED == jsyn.TABLE2_PUBLISHED


@pytest.mark.parametrize("index", range(len(jsyn.TABLE1)))
def test_operating_point_metrics(index):
    t, j = tsyn.TABLE1[index], jsyn.TABLE1[index]
    for prop in ("gflops", "gflops_per_mm2", "gflops_per_watt"):
        assert getattr(t, prop) == pytest.approx(getattr(j, prop), rel=RTOL)


def test_derived_table2_and_ratios_match_reference():
    _close_tree(tsyn.derive_table2(), jsyn.derive_table2())
    _close_tree(tsyn.efficiency_ratios(), jsyn.efficiency_ratios())


@pytest.mark.parametrize("design", DESIGNS)
def test_power_model_fit_matches_reference(design):
    t, j = tsyn.fit_power_model(design), jsyn.fit_power_model(design)
    assert t.design == j.design
    for field in ("c_dyn", "v0", "v1", "p_leak"):
        assert getattr(t, field) == pytest.approx(getattr(j, field), rel=RTOL)
    for f in (0.2, 0.33, 0.95, 1.2, 1.81):
        assert t.power_mw(f) == pytest.approx(j.power_mw(f), rel=RTOL)
        assert t.gflops_per_watt(f) == pytest.approx(j.gflops_per_watt(f),
                                                     rel=RTOL)
        assert tsyn.energy_per_flop_pj(design, f) == pytest.approx(
            jsyn.energy_per_flop_pj(design, f), rel=RTOL)


@pytest.mark.parametrize("tol", [0.06, 0.5])
def test_check_table2_matches_reference(tol):
    _close_tree(tsyn.check_table2(tol), jsyn.check_table2(tol))


def test_check_table2_refuses_as_reference():
    for mod in (jsyn, tsyn):
        with pytest.raises(AssertionError, match="Table 2 derivation off"):
            mod.check_table2(1e-4)
