"""The card route traced with no card: fake CUDA tensors, launch records.

Every test here traces ``repro_torch`` on fake CUDA tensors
(``repro_torch.analysis``'s trace) with ``kernels._build.library`` made to
raise: no nvcc, no ctypes call, no card. The launch records must be the
ones the ``h100`` plans imply, counted as ``chip_smoke.py`` derives them
(B2 once per fused trailing update, B1 twice per QR panel with trailing
columns, B1's ``gemv`` once per off-diagonal TRSM update, B5 and B6 once
per hybrid layer), and KL001-KL004 must fire on seeded launches.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import analysis, linalg
from repro_torch.analysis import fake_card, kernel_lint
from repro_torch.core.codesign import TRSM_GEMM_TILE, cta_smem_bytes
from repro_torch.kernels import _build, fused, gemm as gk, launch_record
from repro_torch.tune import dispatch as td

CARD = torch.device("cuda")


@pytest.fixture(autouse=True)
def no_library(monkeypatch):
    """A fake launch must never reach the build or ctypes."""
    def refuse(stem):
        raise AssertionError(f"_build.library({stem!r}) reached")
    monkeypatch.setattr(_build, "library", refuse)


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _spd(n):
    g = _f32(n, n)
    return (g @ g.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _trace(fn, *args, **kw):
    with linalg.use(policy="model"):
        return fake_card.trace(fn, args, kw, CARD)


def _kinds(tr):
    out = {}
    for r in tr.launches:
        key = f"{r['kernel']}/{r['variant']}"
        out[key] = out.get(key, 0) + 1
    return out


def _fused_updates(n, block, kind_form):
    """B2 launches a blocked factorization's h100 plans imply: one per
    trailing update the chain planner fuses."""
    count = 0
    for j0 in range(0, n, block):
        nb = min(block, n - j0)
        if j0 + nb < n:
            r = n - j0 - nb
            count += td.resolve("trsm+gemm", (r, r, nb), torch.float32,
                                policy="model", backend="cuda",
                                form=kind_form).fused
    return count


def test_gemm_records_the_plan_tile_and_its_geometry():
    before = gk.gemm.launches
    tr = _trace(linalg.gemm, _f32(48, 32), _f32(32, 64))
    (rec,) = tr.launches
    plan = td.resolve("gemm", (48, 64, 32), torch.float32, policy="model",
                      backend="cuda").gemm_plan
    tile, source = gk.launch_tile("ffma", plan)
    assert (rec["kernel"], rec["variant"], rec["fake"]) == \
        ("gemm", "ffma", True)
    assert rec["tile"] == tile and source == "plan"
    assert rec["grid"] == (-(-48 // tile[0]) * -(-64 // tile[1]),)
    stages = [t for t in gk.HOPPER_TILES[4][1] if t[:3] == tile][0][3]
    assert rec["smem_bytes"] == cta_smem_bytes(4, *tile, stages)
    # the c_int slots of repro_gemm: variant, tile, dtypes, m, n, k
    assert rec["ints"] == (gk.VARIANTS.index("ffma"), *tile, 0, 0, 48, 64,
                           32)
    n_int = sum(t is ctypes.c_int for t in
                _build.SIGNATURES["gemm"]["repro_gemm"][0])
    assert len(rec["ints"]) == n_int
    assert rec["operands"][0] == ((48, 32), "float32", (32, 1), 0)
    assert rec["site"] == "repro_torch/kernels/gemm.py:gemm"
    assert gk.gemm.launches == before       # a fake launch counts nothing
    assert kernel_lint.lint_kernel_launches(tr.launches) == []


def test_cholesky_and_lu_launch_b2_once_per_fused_update():
    n, block = 96, 32
    for fn, form, arg in ((linalg.cholesky, "syrk", _spd(n)),
                          (linalg.lu, "lu", _f32(n, n))):
        tr = _trace(fn, arg, block=block)
        want = _fused_updates(n, block, form)
        assert want == 2
        assert _kinds(tr) == {"trsm_gemm/ffma": want}, fn
        for rec in tr.launches:
            plan = fused.trsm_gemm_plan(torch.float32, block, form)
            assert rec["tile"] == TRSM_GEMM_TILE
            assert rec["smem_bytes"] == plan.smem_bytes
            co = fused.co_resident_ctas(torch.float32, plan.smem_bytes,
                                        launch_record.h100().pe.sm_count)
            assert rec["grid"][0] <= co


def test_qr_launches_b1_twice_per_panel_with_trailing_columns():
    n, block = 64, 32
    tr = _trace(linalg.qr, _f32(n, n), block=block)
    panels = sum(j0 + min(block, n - j0) < n for j0 in range(0, n, block))
    assert _kinds(tr) == {"gemm/ffma": 2 * panels}


def test_trsm_launches_gemv_once_per_update():
    n, nrhs = 256, 4
    t = np.tril(_f32(n, n)) + n * np.eye(n, dtype=np.float32)
    tr = _trace(linalg.trsm, t, _f32(n, nrhs))
    block = td.resolve("trsm", (n, nrhs), torch.float32, policy="model",
                       backend="cuda").block
    assert _kinds(tr) == {"gemm/gemv": -(-n // block) - 1}
    for rec in tr.launches:
        m, k = rec["operands"][0][0]
        segs, ks = gk.gemv_split(m, k, launch_record.h100().pe.sm_count)
        assert rec["grid"] == (segs, -(-m // gk.TILES["gemv"][0]))
        assert ks in rec["ints"]


def test_b3_and_b4_record_their_launches():
    from repro_torch.kernels import dotp as dk

    def both(a, b, bias, x):
        fused.gemm_bias_act(a, b, bias, "relu")
        return dk.dotp(x, x)
    n = 1 << 20
    tr = fake_card.trace(both, (_f32(64, 32), _f32(32, 64), _f32(64),
                                _f32(n)), {}, CARD)
    b3, b4 = tr.launches
    assert (b3["kernel"], b3["entry"], b3["variant"]) == \
        ("gemm_bias_act", "repro_gemm_bias_act", "ffma")
    assert b3["site"] == "repro_torch/kernels/fused.py:gemm_bias_act"
    sms = launch_record.h100().pe.sm_count
    blocks = dk.dotp_grid(n, sms, dk.BLOCKS_PER_SM[torch.float32, True], 4,
                          True)
    assert (b4["kernel"], b4["variant"], b4["grid"]) == \
        ("dotp", "vector", (blocks,))
    assert kernel_lint.lint_kernel_launches(tr.launches) == []


def test_hybrid_prefill_launches_b5_and_b6_once_per_layer():
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo as zoo
    cfg = dataclasses.replace(reduce_config(
        registry.get_config("hymba-1.5b"), layers=3, d_model=64, vocab=128,
        heads=4), dtype="bfloat16")

    def build():
        model = zoo.build(cfg, device=CARD)
        tokens = torch.zeros((2, 64), dtype=torch.int32, device=CARD)
        return (lambda m, t: zoo.prefill(m, {"tokens": t}, cfg)), \
            (model, tokens), {}
    tr = fake_card.run(build, CARD)
    kinds = _kinds(tr)
    assert sum(v for k, v in kinds.items() if k.startswith("attention/")) \
        == cfg.n_layers
    assert kinds.get("ssd_scan/mma") == cfg.n_layers
    for rec in tr.launches:
        if rec["kernel"] == "ssd_scan":
            assert len(rec["grid"]) == 3 and len(rec["smem_bytes"]) == 3
    assert kernel_lint.lint_kernel_launches(tr.launches) == []


def test_card_route_check_is_clean_and_needs_no_card():
    rep = analysis.check(linalg.gemm, _f32(48, 32), _f32(32, 64))
    assert rep.findings == [], rep.summary()
    if not torch.cuda.is_available():     # a real call without a card
        with pytest.raises(RuntimeError):  # still raises
            linalg.gemm(_f32(4, 4), _f32(4, 4))


# ------------------------- seeded launches: KL001-4 -------------------------

def _gemm_record(**change):
    tr = _trace(linalg.gemm, _f32(48, 32), _f32(32, 64))
    return dict(tr.launches[0], **change)


def test_kl_rules_fire_on_seeded_launches():
    ok = _gemm_record()
    assert kernel_lint.lint_launch(ok) == []
    cases = {
        "KL001": _gemm_record(tile=(32, 32, 8)),
        "KL002": _gemm_record(smem_bytes=300_000),
        "KL003": _gemm_record(ints=ok["ints"][:-1] + (2 ** 31,)),
        "KL004": _gemm_record(grid=(0,)),
    }
    for rule, rec in cases.items():
        assert [f.rule for f in kernel_lint.lint_launch(rec)] == [rule]
    # a zero-dim operand is KL004 too, and any launch at all when the
    # inputs were zero-dim (the call must take the plain route)
    zero = _gemm_record(operands=(((0, 32), "float32", (32, 1), 0),)
                        + ok["operands"][1:])
    assert "KL004" in [f.rule for f in kernel_lint.lint_launch(zero)]
    assert [f.rule for f in kernel_lint.lint_kernel_launches(
        [ok], zero_dim_inputs=True)] == ["KL004"]
    # the tiled variants' layout condition: A's rows off 16 bytes
    bad = _gemm_record(operands=(((48, 32), "float32", (32, 1), 4),)
                       + ok["operands"][1:])
    assert [f.rule for f in kernel_lint.lint_launch(bad)] == ["KL001"]


def test_real_launch_path_records_nothing_without_a_scope():
    assert not launch_record.active()
    with launch_record.record_launches() as rec:
        assert launch_record.active()
    assert rec == [] and not launch_record.active()


def test_fake_branch_is_taken_only_inside_a_scope():
    """Outside a record scope a wrapper asks nothing about its operands and
    takes the real route, fake tensors or not (here: the refused build)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty((48, 32), device="cuda")
        b = torch.empty((32, 64), device="cuda")
        with pytest.raises(AssertionError, match="_build.library"):
            gk.gemm(a, b)
        with launch_record.record_launches() as rec:
            gk.gemm(a, b)
    assert [(r["kernel"], r["fake"]) for r in rec] == [("gemm", True)]
