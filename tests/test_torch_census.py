"""repro_torch.core.fx_census (aten graphs) against repro.core.jaxpr_census
(jaxprs) on the same functions written in each framework.

Straight-line functions (a product, the elementwise classes, reductions, a
softmax written out, a product with bias, a mean, integer powers and
transcendentals, a batched product, a cumulative sum): N_I, N_H, flops and
the critical path equal. Each documented difference of the module's
docstring is asserted exactly: ``torch.softmax`` against
``jax.nn.softmax``, a nested ``jit`` (``jax.nn.silu``), and the two scan
cases of tests/test_codesign_census.py as Python loops. A small dense
model's forward, carried across with ``convert.from_jax_params(...,
device="cpu")``: N_I per class and flops within 1e-3 relative of the
reference once the reference's skipped ``silu`` bodies are added to its
side (the adds differ by 162 of 739,298: jax.nn.softmax's guard, 128
here, and 34 of other lowering); hazards and critical path are not
compared (the reference scans the layers, the port unrolls them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import jaxpr_census as jc
from repro.models import model_zoo as jzoo
from repro.models.config import ModelConfig as JConfig
from repro_torch.core import fx_census as tc
from repro_torch.models import convert
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.config import ModelConfig as TConfig

S = jax.ShapeDtypeStruct
F32 = jnp.float32


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _jsoftmax(x):
    e = jnp.exp(x - jnp.expand_dims(x.max(-1), -1))
    return e / jnp.expand_dims(e.sum(-1), -1)


def _tsoftmax(x):
    e = torch.exp(x - x.amax(-1).unsqueeze(-1))
    return e / e.sum(-1).unsqueeze(-1)


STRAIGHT = {
    "matmul": (lambda a, b: a @ b, [(32, 64), (64, 16)],
               lambda a, b: a @ b),
    "elementwise": (lambda x: jnp.sqrt(x) / (x + 1.0) * jnp.exp(x), [(100,)],
                    lambda x: torch.sqrt(x) / (x + 1.0) * torch.exp(x)),
    "reductions": (lambda x: x.sum(-1).max(), [(32, 64)],
                   lambda x: x.sum(-1).max()),
    "softmax": (_jsoftmax, [(4, 16)], _tsoftmax),
    "bias": (lambda x, w, b: x @ w + b, [(8, 32), (32, 16), (16,)],
             lambda x, w, b: torch.addmm(b, x, w)),
    "mean": (lambda x: x.mean(-1), [(8, 32)], lambda x: x.mean(-1)),
    "pow_transcendental": (
        lambda x: x ** 3 + jnp.tanh(x) - jax.nn.sigmoid(x) * jnp.log(x),
        [(8, 32)],
        lambda x: x ** 3 + torch.tanh(x) - torch.sigmoid(x) * torch.log(x)),
    "bmm": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
            [(3, 8, 32), (3, 32, 16)], torch.bmm),
    "cumsum": (lambda x: jax.lax.cumsum(x, 0), [(8, 32)],
               lambda x: torch.cumsum(x, 0)),
    "rsqrt_maximum": (
        lambda x, y: jax.lax.rsqrt(x) * x - jnp.maximum(x, y),
        [(8, 32), (8, 32)],
        lambda x, y: torch.rsqrt(x) * x - torch.maximum(x, y)),
}


def _pair(case):
    jf, shapes, tf = STRAIGHT[case]
    return (jc.census_of(jf, *[S(s, F32) for s in shapes]),
            tc.census_of(tf, *[meta(*s) for s in shapes]))


@pytest.mark.parametrize("case", sorted(STRAIGHT))
def test_straight_line_census_equals_reference(case):
    j, t = _pair(case)
    assert t.n_i == j.n_i
    assert t.n_h == j.n_h
    assert t.flops == j.flops
    assert t.critical_path == j.critical_path
    assert t.hazard_ratios() == j.hazard_ratios()


@pytest.mark.parametrize("case", ["matmul", "softmax", "pow_transcendental"])
def test_profile_and_report_equal_reference(x64, case):
    j, t = _pair(case)
    tp, jp = t.to_profile(), j.to_profile()
    assert {k: vars(p) for k, p in tp.pipes.items()} == \
        {k: vars(p) for k, p in jp.pipes.items()}
    assert tp.optimal_depths() == jp.optimal_depths()
    t.name = j.name
    t.n_eqns = j.n_eqns
    assert tc.report(t) == jc.report(j)


def test_real_tensors_pytrees_and_kwargs_census_alike():
    def f(d, scale=1.0):
        return (d["a"] @ d["b"]) * scale
    shapes = {"a": (4, 8), "b": (8, 3)}
    want = tc.census_of(f, {k: meta(*s) for k, s in shapes.items()},
                        scale=2.0)
    got = tc.census_of(f, {k: torch.ones(*s) for k, s in shapes.items()},
                       scale=2.0, name="real")
    assert (got.n_i, got.n_h, got.critical_path, got.name) == \
        (want.n_i, want.n_h, want.critical_path, "real")


def test_library_softmax_difference_is_the_documented_one():
    """jax.nn.softmax's max(-inf, .) guard: one add-class op per row, a
    back-to-back hazard each, and four equations more on the critical path
    (the guard, two broadcast_in_dim, one stop_gradient)."""
    rows = 4
    j = jc.census_of(lambda x: jax.nn.softmax(x, -1), S((rows, 16), F32))
    t = tc.census_of(lambda x: torch.softmax(x, -1), meta(rows, 16))
    assert {k: t.n_i[k] for k in t.n_i if k != "add"} == \
        {k: j.n_i[k] for k in j.n_i if k != "add"}
    assert t.n_i["add"] == j.n_i["add"] - rows
    assert t.n_h["add"] == j.n_h["add"] - rows
    assert t.flops == j.flops - rows
    assert t.critical_path == j.critical_path - 4
    # the written-out softmax is the same function on both sides
    assert _pair("softmax")[1].n_i == t.n_i


def test_nested_jit_difference_is_the_documented_one():
    """jax.nn.silu is a nested jit the reference's walk does not enter: it
    counts one equation and no ops; the port counts a sigmoid and a
    multiply per element."""
    j = jc.census_of(jax.nn.silu, S((8, 32), F32))
    t = tc.census_of(F.silu, meta(8, 32))
    assert sum(j.n_i.values()) == 0 and j.critical_path == 1
    assert t.n_i == dict(j.n_i, mul=256.0, exp=256.0)
    assert t.n_h["mul"] == 256.0 and t.critical_path == 2


# tests/test_codesign_census.py's two scans, as Python loops
def _jscan_affine(x):
    return jax.lax.scan(lambda c, _: (c * 0.9 + 1.0, None), x, None,
                        length=50)[0]


def _tloop_affine(x):
    for _ in range(50):
        x = x * 0.9 + 1.0
    return x


def _jscan_add(x):
    return jax.lax.scan(lambda c, _: (c + 1.0, None), x, None,
                        length=64)[0]


def _tloop_add(x):
    for _ in range(64):
        x = x + 1.0
    return x


def test_loop_carried_hazards_come_from_the_unrolled_chain():
    """c * 0.9 + 1.0 over 50 steps of 8 lanes. Equal instruction counts;
    the reference books the loop-carried term 8 * 49 on the adder and
    clips it at N_I, the unrolled chain books it on the multiplier (each
    step's multiply consumes the previous step's add); the critical path
    lacks the scan equation's +1. The reference test's own claims hold."""
    j = jc.census_of(_jscan_affine, S((8,), F32))
    t = tc.census_of(_tloop_affine, meta(8))
    assert t.n_i == j.n_i
    assert t.n_h["add"] == j.n_h["add"] == 400.0
    assert j.n_h["mul"] == 0.0 and t.n_h["mul"] == 8 * 49
    assert t.critical_path == j.critical_path - 1 == 100.0
    assert t.n_h["add"] / t.n_i["add"] > 0.9 and t.critical_path > 50


def test_recurrence_census_equals_reference_but_scan_step():
    """c + 1.0 over 64 steps of 4 lanes: the adder's chain hazards are the
    reference's loop-carried term exactly; the critical path lacks the
    scan equation's +1; eq. 7 still puts a GEMM's adder deeper."""
    j = jc.census_of(_jscan_add, S((4,), F32))
    t = tc.census_of(_tloop_add, meta(4))
    assert (t.n_i, t.n_h, t.flops) == (j.n_i, j.n_h, j.flops)
    assert t.critical_path == j.critical_path - 1 == 64.0
    gemm = tc.census_of(lambda a, b: a @ b, meta(64, 64), meta(64, 64))
    assert gemm.to_profile().optimal_depths()["add"] > \
        t.to_profile().optimal_depths()["add"]


def test_dense_model_forward_census_within_tolerance():
    kw = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=2,
              n_kv=1, d_ff=64, vocab=64, dtype="float32")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    params = jzoo.init(jax.random.PRNGKey(0), jcfg)
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    batch, seq = 2, 16
    j = jc.census_of(lambda p, tok: jzoo.forward(p, {"tokens": tok},
                                                 jcfg)[0],
                     jax.eval_shape(lambda: params), S((batch, seq),
                                                       jnp.int32))
    t = tc.census_of(lambda tok: tzoo.forward(model, {"tokens": tok},
                                              tcfg)[0],
                     meta(batch, seq, dtype=torch.int32))
    # the reference's skipped silu bodies: a sigmoid and a multiply per
    # element of each layer's d_ff activation
    silu = kw["n_layers"] * batch * seq * kw["d_ff"]
    want = dict(j.n_i, mul=j.n_i["mul"] + silu, exp=j.n_i["exp"] + silu)
    for k in tc.CLASSES:
        assert t.n_i[k] == pytest.approx(want[k], rel=1e-3), k
    assert t.flops == pytest.approx(j.flops + 2 * silu, rel=1e-3)
    assert t.n_i["mul"] > 5e4 and t.n_i["exp"] > 0
    assert set(t.to_profile().optimal_depths()) <= \
        {"mul", "add", "div", "sqrt"}
