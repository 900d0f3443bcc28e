"""The benchmark's yardstick on the CPU: the LAWN 41 counts, the plain
references against ``torch.linalg``, the launch cost model and the
classing of the port's kernels."""
import importlib
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness, kernels, roofline  # noqa: E402
from bench.reference import gels, posv  # noqa: E402


@pytest.mark.parametrize("count, m, n, nrhs, want", [
    ("posv", 3, 3, 1, 9 + 18),            # 27/3 + 2*9
    ("posv", 6, 6, 2, 72 + 144),          # 216/3 + 2*36*2
    ("gels", 4, 3, 1, 72 - 18 + 30 + 9),  # 2*4*9 - 2*27/3 + (48-18) + 9
    ("gels", 6, 6, 1, 432 - 144 + 72 + 36),
])
def test_lawn41_counts_by_hand(count, m, n, nrhs, want):
    routine = importlib.import_module("bench.reference." + count)
    assert routine.flops(m, n, nrhs) == pytest.approx(want)


def test_lawn41_counts_of_the_cells():
    assert 2048 * posv.flops(512, 512, 1) == pytest.approx(9.2699e10,
                                                          rel=1e-4)
    assert 2048 * gels.flops(512, 256, 1) == pytest.approx(1.1547e11,
                                                          rel=1e-4)
    with pytest.raises(FileNotFoundError):
        harness.Spec().routine("gemm")


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("n", [5, 96, 300])
def test_potrf_reference_against_torch(n):
    g = _gen()
    x = torch.randn(3, n, n, generator=g, dtype=torch.float64)
    a = x @ x.mT / n + torch.eye(n, dtype=torch.float64)
    b = torch.randn(3, n, 2, generator=g, dtype=torch.float64)
    fact = posv.factor(a)
    torch.testing.assert_close(fact["factors"], torch.linalg.cholesky(a))
    torch.testing.assert_close(posv.solve(fact, b), torch.linalg.solve(a, b))
    assert posv.factor_numbers(fact, fact) == {"factor_rel": 0.0}


@pytest.mark.parametrize("m, n", [(40, 7), (200, 90), (130, 64)])
def test_geqrf_reference_against_lapack(m, n):
    g = _gen()
    a = torch.randn(3, m, n, generator=g, dtype=torch.float64)
    b = torch.randn(3, m, 1, generator=g, dtype=torch.float64)
    fact = gels.factor(a)
    packed, tau = torch.geqrf(a)           # LAPACK's own reflectors
    torch.testing.assert_close(fact["factors"], packed)
    torch.testing.assert_close(fact["tau"], tau)
    q = gels.form_q(fact["factors"], fact["tau"])
    torch.testing.assert_close(q @ fact["factors"][:, :n].triu(), a)
    torch.testing.assert_close(gels.solve(fact, b),
                               torch.linalg.lstsq(a, b).solution)


def _householder(a, flip):
    """Unblocked Householder QR whose reflector for column ``flip`` maps
    the column to +sign(x0) ||x|| e_1, the other valid choice."""
    a = a.clone()
    n = a.shape[-1]
    tau = torch.zeros(a.shape[0], n, dtype=a.dtype)
    for j in range(n):
        x = a[:, j:, j]
        normx = x.norm(dim=-1)
        s = torch.where(x[:, 0] >= 0, 1.0, -1.0).to(a.dtype)
        beta = s * normx if j == flip else -s * normx
        v = x / (x[:, :1] - beta.unsqueeze(-1))
        v[:, 0] = 1
        tau[:, j] = 2 / (v * v).sum(-1)
        w = (v.unsqueeze(-1) * a[:, j:, j + 1:]).sum(1, keepdim=True)
        a[:, j:, j + 1:] -= tau[:, j, None, None] * v.unsqueeze(-1) * w
        a[:, j, j] = beta
        a[:, j + 1:, j] = v[:, 1:]
    return {"factors": a, "tau": tau}


def test_geqrf_numbers_ignore_the_sign_choice():
    """The other sign at one column gives other reflectors from there on
    and R's row of the other sign, and a valid QR: the comparison reads
    no difference."""
    g = _gen(3)
    a = torch.randn(2, 50, 20, generator=g, dtype=torch.float64)
    fact = gels.factor(a)
    other = _householder(a, flip=3)
    torch.testing.assert_close(_householder(a, flip=-1)["factors"],
                               fact["factors"])
    q = gels.form_q(other["factors"], other["tau"])
    torch.testing.assert_close(q @ other["factors"][:, :20].triu(), a)
    assert (other["factors"][:, 4:, 4:] - fact["factors"][:, 4:, 4:]
            ).abs().max() > 0.1
    nums = gels.factor_numbers(fact, other)
    assert nums["r_rel"] < 1e-13 and nums["q_rel"] < 1e-13


def test_launch_costs():
    gemm = {"kernel": "gemm", "fake": False, "operands": (
        ((64, 128, 384), "float32", (), 0), ((64, 384, 256), "float32", (), 0),
        ((64, 128, 256), "float32", (), 0))}
    flops, nbytes, dtype = roofline.launch_cost(gemm)
    assert flops == 2 * 64 * 128 * 256 * 384
    assert nbytes == 4 * 64 * (128 * 384 + 384 * 256 + 128 * 256)
    syrk = {"kernel": "trsm_gemm", "fake": False, "operands": (
        ((2, 128, 128), "float32", (), 0), ((2, 128, 384), "float32", (), 0),
        ((2, 384, 384), "float32", (), 0))}
    flops, nbytes, _ = roofline.launch_cost(syrk)
    assert flops == 2 * (128 * 128 * 384 + 2 * 384 * 384 * 128)
    assert nbytes == 4 * 2 * (128 * 128 + 2 * 128 * 384 + 2 * 384 * 384)
    lu = dict(syrk, operands=syrk["operands"] + (
        ((2, 384, 128), "float32", (), 0),))
    assert roofline.launch_cost(lu)[1] == nbytes + 4 * 2 * 384 * 128
    seconds, what = roofline.bound(67e12, 0, "float32")
    assert seconds == pytest.approx(1.0) and what == "operations"


def test_kernels_of_the_port_are_classed():
    names = kernels.handwritten(os.path.join(ROOT, "src", "repro_torch"))
    assert names["trsm_gemm_batched_kernel"] == "trsm_gemm"
    assert names["gemm_gemv_kernel"] == names["gemm_ffma_kernel"] == "gemm"
    stem = kernels.Classifier(names).stem
    assert stem("void repro::(anonymous namespace)::trsm_gemm_batched_kernel"
                "<float, float, 64, true, true>(repro::Params)") == \
        "trsm_gemm"
    assert stem("void repro::(anonymous namespace)::gemm_gemv_kernel<float, "
                "float, float, 1, 4, true>(float const*)") == "gemm"
    for eager in ("void at::native::elementwise_kernel<128, 2>()",
                  "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8",
                  "Memcpy DtoD (Device -> Device)"):
        assert stem(eager) is None


def test_kernels_found_in_new_sources(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "panel.cu").write_text(
        "template <int B>\n__global__ void __launch_bounds__(256, "
        "sizeof(float) == 4 ? 2 : 1)\npanel_kernel(float* a) {}\n")
    (tmp_path / "tri.py").write_text(
        "import triton\n@triton.jit\ndef panel_tl(x):\n    pass\n")
    assert kernels.handwritten(str(tmp_path)) == {"panel_kernel": "panel",
                                                  "panel_tl": "tri"}


def test_idle_share_and_mfu_take_the_unprofiled_requests():
    """Device busy per profiled request against the unprofiled requests'
    time; the profiled window's own length is not read."""
    view = harness.TraceView(
        requests=2, window_s=1.0, busy_s=0.18, kernels={}, launches=[],
        classify=lambda name: None, flops_per_request=6.7e10,
        dtype="float32", untraced_latencies_s=[0.14, 0.16],
        untraced_span_s=0.5)
    spec = harness.Spec()
    assert spec.reader("idle_share")(view) == pytest.approx(40.0)
    assert spec.reader("lapack_mfu")(view) == pytest.approx(
        100 * 2 * 6.7e10 / 0.5 / 67e12)
    view.untraced_latencies_s = []
    assert spec.reader("idle_share")(view) is None
    assert spec.reader("lapack_mfu")(view) is None
