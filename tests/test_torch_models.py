"""repro_torch's model zoo and serving path against the JAX package.

Small dense, ssm and hybrid configurations in float32: the same weights
(``repro.models`` initializes them; ``repro_torch.models.convert`` carries
them across as numpy arrays) and the same numpy tokens go through both
packages on the CPU, where the port's ops take the reference's plain
routes. Tolerance: 1e-4 absolute and relative on logits and layer outputs
of order one (f32 sums in another order, over at most a few layers).
Configs, registry, parameter counts and ``reduce_config`` must match
exactly. The port's full-width hymba-1.5b runs on the card in
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.launch.train import reduce_config as jreduce
from repro.models import attention as jattn
from repro.models import hybrid as jhyb
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import model_zoo as jzoo
from repro.models.config import ModelConfig as JConfig
from repro_torch import linalg as tlinalg
from repro_torch import obs as tobs
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import reduce_config as treduce
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import hybrid as thyb
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.config import ModelConfig as TConfig

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                  vocab=97, qkv_bias=True, logit_softcap=30.0),
    "ssm": dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=0,
                vocab=97, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
                tie_embeddings=True),
    "hybrid": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                   vocab=128, ssm_state=16, ssm_head_dim=16, window=8,
                   global_layers=(0,)),
}


def _configs(family, **over):
    kw = dict(name=f"t-{family}", family=family, dtype="float32",
              **SMALL[family])
    kw.update(over)
    return JConfig(**kw), TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **{**TOL, **kw})


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# --------------------------------- configs ----------------------------------

def test_configs_and_registry_match_reference():
    assert treg.ARCHS == jreg.ARCHS
    assert [dataclasses.asdict(s) for s in treg.SHAPES] == \
        [dataclasses.asdict(s) for s in jreg.SHAPES]
    assert treg.all_cells() == jreg.all_cells()
    for arch in jreg.ARCHS:
        j, t = jreg.get_config(arch), treg.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert (t.hd, t.d_inner, t.n_ssm_heads, t.sub_quadratic,
                t.param_count(), t.active_param_count()) == \
            (j.hd, j.d_inner, j.n_ssm_heads, j.sub_quadratic,
             j.param_count(), j.active_param_count())
        assert dataclasses.asdict(treduce(t, 2, 128, vocab=512, heads=4)) \
            == dataclasses.asdict(jreduce(j, 2, 128, vocab=512, heads=4))
        for shape in jreg.SHAPES:
            if not jreg.cell_supported(j, shape)[0]:
                continue
            jkind, jspecs = jreg.input_specs(arch, shape.name)
            tkind, tspecs = treg.input_specs(arch, shape.name)
            assert tkind == jkind
            assert {k: (tuple(s), str(d).removeprefix("torch."))
                    for k, (s, d) in tspecs.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_param_count_and_init_match_reference(family):
    jc, tc = _configs(family)
    assert tzoo.param_count(tc) == jzoo.param_count(jc)
    model = tzoo.init(tc, torch.Generator().manual_seed(0), device="cpu")
    # the same tree of shapes as the reference's pytree
    convert.from_jax_params(_np(jzoo.init(jax.random.PRNGKey(0), jc)), tc,
                            device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        tzoo.param_count(tc)
    assert not any(p.requires_grad for p in model.parameters())
    # truncated normal at +-2 sigma, scaled as the reference
    w = model.embed.table
    assert w.abs().max() <= 2.0 and 0.8 < w.std() < 0.95
    if family != "dense":
        mix = model.blocks[0].ssm or model.blocks[0].mix.ssm
        np.testing.assert_allclose(
            mix.a_log.numpy(), np.log(np.linspace(1.0, 16.0, tc.n_ssm_heads)),
            rtol=1e-6)
    again = tzoo.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_full_width_hymba_counts():
    j, t = jreg.get_config("hymba-1.5b"), treg.get_config("hymba-1.5b")
    assert tzoo.param_count(t) == jzoo.param_count(j)


def test_waiting_families_raise():
    for arch in ("qwen3-moe-235b-a22b", "internvl2-1b", "whisper-small"):
        cfg = treg.get_config(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tzoo.init(cfg, device="cpu")


def test_init_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init(_configs("hybrid")[1])


def test_from_jax_params_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jc, tc = _configs("dense")
    params = _np(jzoo.init(jax.random.PRNGKey(0), jc))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_jax_params(params, tc)


def test_from_jax_params_rejects_a_wrong_tree():
    jc, tc = _configs("dense")
    params = _np(jzoo.init(jax.random.PRNGKey(0), jc))
    bad = dict(params, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm"):
        convert.from_jax_params(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="loaded"):
        convert.from_jax_params({k: v for k, v in params.items()
                                 if k != "head"}, tc, device="cpu")


# ---------------------------------- layers ----------------------------------

def test_layers_match_reference(rng):
    jx, tx = _x(rng, 2, 7, 32)
    jw, tw = _x(rng, 32)
    norm = tlayers.RMSNorm(32, 1e-6)
    norm.scale.copy_(tw)
    _close(norm(tx), jlayers.apply_rmsnorm({"scale": jw}, jx, 1e-6))
    table = rng.normal(size=(50, 32)).astype(np.float32)
    emb = tlayers.Embedding(50, 32)
    emb.table.copy_(torch.from_numpy(table))
    ids = rng.integers(0, 50, size=(2, 7))
    for dt in ("float32", "bfloat16"):
        got = emb(torch.from_numpy(ids), getattr(torch, dt))
        want = jlayers.apply_embedding({"table": jnp.asarray(table)},
                                       jnp.asarray(ids), jnp.dtype(dt))
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 3, (2, 7))
    jh, th = _x(rng, 2, 7, 4, 16)
    _close(tlayers.rope(th, torch.from_numpy(pos.copy()), 500.0),
           jlayers.rope(jh, jnp.asarray(pos), 500.0), atol=1e-5, rtol=1e-5)
    for glu, act in ((True, "silu"), (False, "gelu")):
        p = _np(jlayers.init_ffn(jax.random.PRNGKey(3), 32, 48, glu))
        ffn = tlayers.FFN(32, 48, glu, act)
        convert.load_tree(ffn, p)
        _close(ffn(tx), jlayers.apply_ffn(p, jx, act, jnp.float32))


@pytest.mark.parametrize("window,qkv_bias", [(None, False), (8, True)])
def test_attention_module_matches_reference(rng, window, qkv_bias):
    jc, tc = _configs("dense", qkv_bias=qkv_bias)
    p = _np(jattn.init_attention(jax.random.PRNGKey(1), jc))
    if qkv_bias:   # nonzero biases, so they are exercised
        for b in ("bq", "bk", "bv"):
            p[b] = rng.normal(size=p[b].shape).astype(np.float32)
    mod = tattn.Attention(tc)
    convert.load_tree(mod, p)
    jx, tx = _x(rng, 2, 20, 64)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    _close(mod(tx, torch.from_numpy(pos), window=window),
           jattn.apply_attention(p, jx, jc, jnp.asarray(pos), window=window))
    # decode into a ring of 8 slots, past its wrap
    jcache = jattn.init_kv_cache(jc, 2, 8, jnp.float32)
    tcache = tattn.init_kv_cache(tc, 2, 8, torch.float32)
    step = jax.jit(lambda x, c, w, t, n: jattn.apply_attention_decode(
        p, x, jc, c, w, t, n))
    for t in range(10):
        jy, jcache = step(jx[:, t:t + 1], jcache, t % 8, t, min(t + 1, 8))
        ty, tcache = mod.decode(tx[:, t:t + 1], tcache, t % 8, t,
                                min(t + 1, 8))
        _close(ty, jy)
    _close(tcache["k"], jcache["k"])


def test_mamba_module_matches_reference(rng):
    jc, tc = _configs("ssm")
    p = _np(jmamba.init_mamba(jax.random.PRNGKey(2), jc))
    p["dt_bias"] = rng.normal(size=p["dt_bias"].shape).astype(np.float32)
    mod = tmamba.Mamba2(tc)
    convert.load_tree(mod, p)
    jx, tx = _x(rng, 2, 37, 64)
    _close(mod(tx), jmamba.apply_mamba(p, jx, jc))
    jcache = jmamba.init_ssm_cache(jc, 2)
    tcache = tmamba.init_ssm_cache(tc, 2)
    step = jax.jit(lambda x, c: jmamba.apply_mamba_decode(p, x, jc, c))
    for t in range(3):
        jy, jcache = step(jx[:, t:t + 1], jcache)
        ty, tcache = mod.decode(tx[:, t:t + 1], tcache)
        _close(ty, jy)
    _close(tcache["state"], jcache["state"])
    _close(tcache["conv"], jcache["conv"])


@pytest.mark.parametrize("is_global", [False, True])
def test_hybrid_module_matches_reference(rng, is_global):
    jc, tc = _configs("hybrid")
    p = _np(jhyb.init_hybrid(jax.random.PRNGKey(4), jc))
    p["attn_scale"] = np.float32(0.7)
    mod = thyb.Hybrid(tc, is_global)
    convert.load_tree(mod, p)
    jx, tx = _x(rng, 2, 24, 64)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    _close(mod(tx, torch.from_numpy(pos)),
           jhyb.apply_hybrid(p, jx, jc, jnp.asarray(pos), is_global))
    jcache = jhyb.init_hybrid_cache(jc, 2, 16, is_global, jnp.float32)
    tcache = thyb.init_hybrid_cache(tc, 2, 16, is_global, torch.float32)
    assert tcache["attn"]["k"].shape == jcache["attn"]["k"].shape
    step = jax.jit(lambda x, c, t: jhyb.apply_hybrid_decode(
        p, x, jc, c, t, is_global))
    for t in range(9):                 # the 8-slot ring wraps once
        jy, jcache = step(jx[:, t:t + 1], jcache, t)
        ty, tcache = mod.decode(tx[:, t:t + 1], tcache, t)
        _close(ty, jy)


# ----------------------------------- model ----------------------------------

@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_lm_forward_prefill_decode_match_reference(rng, family):
    jc, tc = _configs(family)
    params = jzoo.init(jax.random.PRNGKey(1), jc)
    model = convert.from_jax_params(_np(params), tc, device="cpu")
    toks = rng.integers(0, jc.vocab, size=(2, 40)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jl, _ = jzoo.forward(params, jb, jc)
    tl, aux = tzoo.forward(model, tb, tc)
    assert tl.shape == (2, 40, jc.vocab) and float(aux) == 0.0
    _close(tl, jl)
    jl, _, jkv = jzoo.prefill(params, jb, jc)
    tl, _, tkv = tzoo.prefill(model, tb, tc)
    _close(tl, jl)
    assert (tkv is None) == (jkv is None)
    if jkv is not None:
        _close(tkv["k"], jkv["k"])
        _close(tkv["v"], jkv["v"])
    jcache = jzoo.init_caches(params, jc, 2, 48, dtype=jnp.float32)
    tcache = tzoo.init_caches(model, tc, 2, 48, dtype=torch.float32)
    step = jax.jit(lambda tok, c, i: jzoo.decode_step(params, tok, jc, c, i))
    for t in range(9):                 # hybrid's 8-slot rings wrap once
        jlg, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        tlg, tcache = tzoo.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]), tc, tcache, t)
        _close(tlg, jlg)


def test_hybrid_decode_equals_forward():
    """The port's own decode path (ring caches on windowed layers) equals
    its full-sequence forward, as the reference's does (< 1e-4)."""
    _, tc = _configs("hybrid")
    model = tzoo.init(tc, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, size=(2, 12)))
    full, _ = tzoo.forward(model, {"tokens": toks}, tc)
    caches = tzoo.init_caches(model, tc, 2, 16, dtype=torch.float32)
    dec = []
    for t in range(12):
        lg, caches = tzoo.decode_step(model, toks[:, t:t + 1], tc, caches, t)
        dec.append(lg[:, 0])
    assert (torch.stack(dec, 1) - full).abs().max().item() < 1e-4


def _requests(cls, rng, vocab):
    return [cls(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 4), (9, 6), (3, 5))]


def test_serve_batch_matches_reference_tokens():
    jc, tc = _configs("hybrid")
    params = jzoo.init(jax.random.PRNGKey(0), jc)
    model = convert.from_jax_params(_np(params), tc, device="cpu")
    jouts, jstats = jserve.serve_batch(
        params, jc, _requests(jserve.Request, np.random.default_rng(0),
                              jc.vocab), max_len=32)
    tr = tobs.Trace("serve")
    touts, tstats = tserve.serve_batch(
        model, tc, _requests(tserve.Request, np.random.default_rng(0),
                             tc.vocab), max_len=32,
        context=tlinalg.ExecutionContext(obs=tr))
    tr.finish()
    assert [list(map(int, o)) for o in touts] == \
        [list(map(int, o)) for o in jouts]
    assert tstats["steps"] == jstats["steps"]
    (batch,) = tr.spans(name="serve.batch")
    assert batch.attrs["requests"] == 3
    assert tr.spans(name="serve.prefill")
    (dec,) = tr.spans(name="serve.decode")
    assert dec.attrs["steps"] == tstats["steps"]
    assert len(tr.spans(name="serve.request")) == 3


def test_serve_sampling_follows_the_generator():
    _, tc = _configs("hybrid")
    model = tzoo.init(tc, torch.Generator().manual_seed(0), device="cpu")

    def run(seed):
        reqs = _requests(tserve.Request, np.random.default_rng(0), tc.vocab)
        return tserve.serve_batch(model, tc, reqs, max_len=32,
                                  temperature=1.0, generator=torch.Generator()
                                  .manual_seed(seed))[0]
    assert run(3) == run(3)
    assert all(0 <= t < tc.vocab for o in run(4) for t in o)
