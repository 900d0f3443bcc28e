"""repro_torch's moe family against the JAX package.

The same weights (``repro.models`` initializes them, ``convert`` carries
them across as numpy arrays) and the same numpy inputs go through both
packages on the CPU, where the port's ops take the reference's plain
routes. Small configs in float32; tolerance 1e-4 absolute and relative on
outputs of order one (f32 sums in another order: the port combines each
token's k gated slots by a sum over k, the reference scatter-adds them in
expert order). The capacity factor 0.5 runs drop assignments for sure (E
cap < T k), so both sides must drop the same ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig

TOL = dict(atol=1e-4, rtol=1e-4)
MOE = dict(name="t-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv=2, d_ff=96, vocab=97, n_experts=8, top_k=2, d_expert=48,
           dtype="float32")


def _configs(**over):
    kw = dict(MOE, **over)
    return JConfig(**kw), TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("top_k,n_experts,factor",
                         [(2, 8, 1.25), (8, 128, 1.25), (8, 384, 1.25),
                          (2, 8, 0.5), (1, 4, 2.0)])
def test_capacity_matches_reference(top_k, n_experts, factor):
    jc, tc = _configs(top_k=top_k, n_experts=n_experts,
                      capacity_factor=factor)
    for n in (1, 7, 8, 63, 64, 100, 1000, 4096, 8192, 10 ** 6 + 3):
        assert tmoe.capacity(n, tc) == jmoe.capacity(n, jc), n


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("grouped", [False, True])
def test_moe_matches_reference(rng, grouped, glu, act, factor):
    jc, tc = _configs(glu=glu, act=act, capacity_factor=factor,
                      moe_grouped=grouped)
    p = _np(jmoe.init_moe(jax.random.PRNGKey(5), jc))
    mod = tmoe.MoE(tc)
    assert convert.load_tree(mod, p) == (4 if glu else 3)
    b, s = 2, 48
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    jy, jaux = jax.jit(lambda x: jmoe.apply_moe(p, x, jc))(jnp.asarray(x))
    ty, taux = mod(torch.from_numpy(x))
    assert ty.shape == (b, s, 64) and taux.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)
    t = s if grouped else b * s
    if factor == 0.5:                  # fewer slots than assignments
        assert tc.n_experts * tmoe.capacity(t, tc) < t * tc.top_k


def test_moe_drops_zero_the_dropped_assignments(rng):
    """At a capacity of 8 slots a token routed to a full expert gets no
    output from it: with every token sent to one expert (a router that
    prefers it by far), only the first 8 tokens of the sorted order keep
    that slot, as in the reference."""
    jc, tc = _configs(capacity_factor=0.01, top_k=1)
    p = {k: np.array(v) for k, v in
         _np(jmoe.init_moe(jax.random.PRNGKey(6), jc)).items()}
    p["router"][:, 3] += 50.0 * np.sign(p["router"][:, 3] + 1e-9)
    mod = tmoe.MoE(tc)
    convert.load_tree(mod, p)
    x = np.abs(rng.normal(size=(1, 20, 64))).astype(np.float32) \
        * np.sign(p["router"][:, 3])
    ty, _ = mod(torch.from_numpy(x))
    jy, _ = jmoe.apply_moe(p, jnp.asarray(x), jc)
    _close(ty, jy)
    kept = (ty[0].abs().sum(-1) > 0).numpy()
    assert kept[:8].all() and not kept[8:].any()


def test_lm_moe_forward_prefill_decode_match_reference(rng):
    jc, tc = _configs()
    params = jzoo.init(jax.random.PRNGKey(1), jc)
    model = convert.from_jax_params(_np(params), tc, device="cpu")
    toks = rng.integers(0, jc.vocab, size=(2, 20)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jl, jaux = jzoo.forward(params, jb, jc)
    tl, taux = tzoo.forward(model, tb, tc)
    assert float(taux) > 0 and taux.dtype == torch.float32
    _close(tl, jl)
    _close(taux, jaux)
    jl, jaux, jkv = jzoo.prefill(params, jb, jc)
    tl, taux, tkv = tzoo.prefill(model, tb, tc)
    _close(tl, jl)
    _close(taux, jaux)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])
    jcache = jzoo.init_caches(params, jc, 2, 16, dtype=jnp.float32)
    tcache = tzoo.init_caches(model, tc, 2, 16, dtype=torch.float32)
    step = jax.jit(lambda tok, c, i: jzoo.decode_step(params, tok, jc, c, i))
    for t in range(9):
        jlg, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        tlg, tcache = tzoo.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]), tc, tcache, t)
        _close(tlg, jlg)
    _close(tcache["k"], jcache["k"])


def test_lm_moe_grouped_aux_is_the_mean_over_rows(rng):
    jc, tc = _configs(moe_grouped=True, n_layers=1)
    params = jzoo.init(jax.random.PRNGKey(2), jc)
    model = convert.from_jax_params(_np(params), tc, device="cpu")
    toks = rng.integers(0, jc.vocab, size=(3, 16)).astype(np.int32)
    jl, jaux = jzoo.forward(params, {"tokens": jnp.asarray(toks)}, jc)
    tl, taux = tzoo.forward(model, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    _close(taux, jaux)


def _requests(cls, rng, vocab):
    return [cls(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 4), (9, 6), (3, 5))]


def test_serve_batch_moe_matches_reference_tokens():
    jc, tc = _configs()
    params = jzoo.init(jax.random.PRNGKey(0), jc)
    model = convert.from_jax_params(_np(params), tc, device="cpu")
    jouts, jstats = jserve.serve_batch(
        params, jc, _requests(jserve.Request, np.random.default_rng(0),
                              jc.vocab), max_len=32)
    touts, tstats = tserve.serve_batch(
        model, tc, _requests(tserve.Request, np.random.default_rng(0),
                             tc.vocab), max_len=32)
    assert [list(map(int, o)) for o in touts] == \
        [list(map(int, o)) for o in jouts]
    assert tstats["steps"] == jstats["steps"]


def test_from_jax_params_rejects_a_wrong_moe_tree():
    jc, tc = _configs()
    params = _np(jzoo.init(jax.random.PRNGKey(0), jc))
    blocks = params["blocks"]

    def with_moe(**moe):
        return dict(params, blocks=dict(blocks, moe=moe))
    # an expert axis too short, a layer stack too deep, a missing gate, a
    # dense FFN beside the experts
    short = dict(blocks["moe"], w_in=blocks["moe"]["w_in"][:, :7])
    with pytest.raises(ValueError, match="blocks/0/moe/w_in"):
        convert.from_jax_params(with_moe(**short), tc, device="cpu")
    deep = dict(blocks["moe"], router=np.concatenate(
        [blocks["moe"]["router"]] * 2))
    with pytest.raises(ValueError, match="stack"):
        convert.from_jax_params(with_moe(**deep), tc, device="cpu")
    gateless = {k: v for k, v in blocks["moe"].items() if k != "w_gate"}
    with pytest.raises(ValueError, match="loaded"):
        convert.from_jax_params(with_moe(**gateless), tc, device="cpu")
    ffn = {"w_in": np.zeros((2, 64, 96), np.float32)}
    with pytest.raises(KeyError, match="ffn"):
        convert.from_jax_params(dict(params, blocks=dict(blocks, ffn=ffn)),
                                tc, device="cpu")


def test_moe_every_other_layer_is_refused():
    _, tc = _configs(moe_every=2)
    with pytest.raises(AssertionError, match="moe"):
        tzoo.init(tc, device="cpu")


def test_init_moe_draws_the_reference_scales():
    _, tc = _configs(n_experts=16, d_expert=256, d_model=128)
    model = tzoo.init(tc, torch.Generator().manual_seed(0), device="cpu")
    moe = model.blocks[0].moe
    for w, fan_in in ((moe.router, 128), (moe.w_in, 128), (moe.w_gate, 128),
                      (moe.w_out, 256)):
        z = w / fan_in ** -0.5
        assert z.abs().max() <= 2.0 and 0.8 < z.std() < 0.95
    assert model.blocks[0].ffn is None
    assert tzoo.param_count(tc) == sum(p.numel() for p in model.parameters())
    assert dataclasses.asdict(tc)["moe_every"] == 1
