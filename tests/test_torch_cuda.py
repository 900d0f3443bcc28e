"""Each CUDA kernel of repro_torch against its plain version, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports neither jax nor ``repro`` (the
machine with the card has no jax), so it runs there without this
directory's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused as fk
from repro_torch.kernels import gemm as gk

# tests/conftest.py's dtype tolerances (rtol, atol), repeated here so the
# file needs no jax
TOL = {"float32": (2e-4, 1e-4), "float64": (1e-12, 1e-12),
       "bfloat16": (5e-2, 5e-2)}
GEMM_SHAPES = [(1, 1, 1), (7, 129, 33), (70, 33, 129), (200, 300, 517)]
# (nb, n, m): ragged panels, and one too wide for 64-column X blocks
TRSM_GEMM_SHAPES = [(8, 8, 8), (13, 130, 70), (100, 300, 260), (2000, 40, 30)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype, scale):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(),
                               rtol=rtol * scale, atol=atol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gemm_kernels_match_plain(card, dtype):
    rng = np.random.default_rng(0)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(
        card, getattr(torch, dtype))
    for m, n, k in GEMM_SHAPES:
        a, b, bias = dev(m, k), dev(k, n), dev(n)
        _close(gk.gemm(a, b), gk.gemm_plain(a, b), dtype, 4.0)
        _close(gk.gemm(b.T, a.T), gk.gemm_plain(b.T, a.T), dtype, 4.0)
        for epi in fk.EPILOGUES:
            _close(fk.gemm_bias_act(a, b, bias, epi),
                   fk.gemm_bias_act_plain(a, b, bias, epi), dtype, 4.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_trsm_gemm_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    dev = lambda x: torch.from_numpy(x).to(card, tdt)
    for nb, n, m in TRSM_GEMM_SHAPES:
        l11 = dev(np.tril(rng.normal(size=(nb, nb)), -1) / nb
                  + np.diag(1 + rng.uniform(size=nb)))
        for form in ("lu", "syrk"):
            mm = n if form == "syrk" else m
            args = (l11, dev(rng.normal(size=(n, nb))).T,
                    None if form == "syrk" else dev(rng.normal(size=(mm, nb))),
                    dev(rng.normal(size=(mm, n))))
            for unit in (False, True):
                x, c = fk.trsm_gemm(*args, form=form, unit_diag=unit)
                xp, cp = fk.trsm_gemm_plain(*args, form=form, unit_diag=unit)
                _close(x, xp, dtype, 4.0)
                _close(c, cp, dtype, 8.0)
    torch.cuda.synchronize()
