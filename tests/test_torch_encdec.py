"""repro_torch's encoder-decoder family against the JAX package.

A small Whisper-style config in float32 (sinusoidal positions, GELU FFN,
no GLU): the reference's parameters carried across by ``convert``, the
same numpy frames and tokens through both packages on the CPU, where the
port's attention takes the reference's plain routes. Tolerance 1e-4
absolute and relative on outputs of order one (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import encdec as tenc
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.config import ModelConfig as TConfig

TOL = dict(atol=1e-4, rtol=1e-4)
ENCDEC = dict(name="t-encdec", family="encdec", n_layers=2, d_model=64,
              n_heads=4, n_kv=4, d_ff=128, vocab=97, act="gelu", glu=False,
              encoder_layers=3, encoder_seq=30, frontend="audio",
              pos="sinusoidal", dtype="float32")
B, S_ENC, S_DEC = 2, 30, 11


def _configs(**over):
    kw = dict(ENCDEC, **over)
    return JConfig(**kw), TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.fixture(scope="module")
def pair():
    jc, tc = _configs()
    params = jzoo.init(jax.random.PRNGKey(7), jc)
    return jc, tc, params, convert.from_jax_params(_np(params), tc,
                                                   device="cpu")


@pytest.mark.parametrize("seq,d", [(1, 8), (30, 64), (1500, 768)])
def test_sinusoidal_positions_match_reference(seq, d):
    """Both sides form the angle pos * freq in f32 and take its sine; the
    two libraries' exp and sin may differ by an ulp, so the entries agree
    to two ulps of the largest angle (< seq: seq 2^-22), and in bf16 to
    one bf16 step of a value at most 1 (2^-8) on top."""
    f32_tol = max(seq * 2.0 ** -22, 2e-6)
    for dt in ("float32", "bfloat16"):
        got = tlayers.sinusoidal_positions(seq, d, getattr(torch, dt))
        want = jlayers.sinusoidal_positions(seq, d, jnp.dtype(dt))
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), rtol=0,
            atol=f32_tol + (2 ** -8 if dt == "bfloat16" else 0))


def test_sinusoidal_positions_odd_width_raises_on_both_sides():
    with pytest.raises(ValueError):
        jlayers.sinusoidal_positions(4, 5)
    with pytest.raises(RuntimeError):
        tlayers.sinusoidal_positions(4, 5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_cross_attention_matches_reference(rng, hq, hkv):
    jc, tc = _configs(n_heads=hq, n_kv=hkv)
    p = _np(jattn.init_attention(jax.random.PRNGKey(8), jc))
    mod = tattn.Attention(tc)
    convert.load_tree(mod, p)
    jx, tx = _x(rng, B, S_DEC, 64)
    jm, tm = _x(rng, B, S_ENC, 64)
    _close(mod.cross(tx, tm), jattn.apply_cross_attention(p, jx, jc, jm))


def test_encode_decode_train_forward_match_reference(rng, pair):
    jc, tc, params, model = pair
    jf, tf = _x(rng, B, S_ENC, 64)
    toks = rng.integers(0, jc.vocab, size=(B, S_DEC)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jmem = jenc.encode(params, jf, jc)
    with torch.no_grad():
        tmem = model.encode(tf)
        _close(tmem, jmem)
        _close(model.decode_train(tt, tmem), jenc.decode_train(
            params, jt, jmem, jc))
    jl, jaux = jzoo.forward(params, {"frames": jf, "tokens": jt}, jc)
    tl, taux = tzoo.forward(model, {"frames": tf, "tokens": tt}, tc)
    assert tl.shape == (B, S_DEC, jc.vocab) and float(taux) == 0.0
    assert taux.dtype == torch.float32
    _close(tl, jl)
    jl, _, jmem = jzoo.prefill(params, {"frames": jf, "tokens": jt}, jc)
    tl, taux, tmem = tzoo.prefill(model, {"frames": tf, "tokens": tt}, tc)
    _close(tl, jl)
    _close(tmem, jmem)
    assert float(taux) == 0.0


def test_decode_caches_and_steps_match_reference(rng, pair):
    jc, tc, params, model = pair
    jf, tf = _x(rng, B, S_ENC, 64)
    toks = rng.integers(0, jc.vocab, size=(B, 9)).astype(np.int32)
    jmem = jenc.encode(params, jf, jc)
    with torch.no_grad():
        tmem = model.encode(tf)
    # an 8-slot self-attention ring: the ninth step wraps it
    jcache = jzoo.init_caches(params, jc, B, 8, memory=jmem,
                              dtype=jnp.float32)
    tcache = tzoo.init_caches(model, tc, B, 8, memory=tmem,
                              dtype=torch.float32)
    assert tcache["self"]["k"].shape == jcache["self"]["k"].shape \
        == (2, B, 8, 4, 16)
    assert tcache["cross_k"].shape == (2, B, S_ENC, 4, 16)
    _close(tcache["cross_k"], jcache["cross_k"])
    _close(tcache["cross_v"], jcache["cross_v"])
    step = jax.jit(lambda tok, c, i: jzoo.decode_step(params, tok, jc, c, i))
    for t in range(9):
        jlg, jcache = step(jnp.asarray(toks[:, t:t + 1]), jcache,
                           jnp.int32(t))
        tlg, tcache = tzoo.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]), tc, tcache, t)
        assert tlg.shape == (B, 1, jc.vocab)
        _close(tlg, jlg)
    _close(tcache["self"]["k"], jcache["self"]["k"])
    _close(tcache["self"]["v"], jcache["self"]["v"])


def test_decode_equals_decode_train(rng, pair):
    """The port's own decode path, token by token against the cached
    memory, equals its teacher-forced pass (< 1e-4), as the reference's
    does."""
    _, tc, _, model = pair
    tf = torch.from_numpy(rng.normal(size=(B, S_ENC, 64)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, tc.vocab, size=(B, 7)))
    with torch.no_grad():
        mem = model.encode(tf)
        full = model.decode_train(toks, mem)
    caches = tzoo.init_caches(model, tc, B, 16, memory=mem,
                              dtype=torch.float32)
    dec = []
    for t in range(7):
        lg, caches = tzoo.decode_step(model, toks[:, t:t + 1], tc, caches, t)
        dec.append(lg[:, 0])
    assert (torch.stack(dec, 1) - full).abs().max().item() < 1e-4


def test_init_caches_need_the_memory(pair):
    _, tc, _, model = pair
    with pytest.raises(AssertionError, match="memory"):
        tzoo.init_caches(model, tc, B, 8)


def test_param_count_and_init_match_reference():
    jc, tc = _configs()
    assert tzoo.param_count(tc) == jzoo.param_count(jc)
    model = tzoo.init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, tenc.EncDec)
    assert len(model.enc_blocks) == 3 and len(model.dec_blocks) == 2
    assert sum(p.numel() for p in model.parameters()) == tzoo.param_count(tc)
    z = model.head / 64 ** -0.5
    assert z.abs().max() <= 2.0 and 0.8 < z.std() < 0.95
    assert torch.equal(model.dec_norm.scale, torch.ones(64))


def test_from_jax_params_rejects_a_wrong_encdec_tree():
    jc, tc = _configs()
    params = _np(jzoo.init(jax.random.PRNGKey(0), jc))
    # the encoder stack one layer short
    short = dict(params, enc_blocks=jax.tree.map(lambda a: a[:2],
                                                 params["enc_blocks"]))
    with pytest.raises(ValueError, match="enc_blocks/0"):
        convert.from_jax_params(short, tc, device="cpu")
    # a decoder block without its cross-attention
    dec = {k: v for k, v in params["dec_blocks"].items() if k != "xattn"}
    with pytest.raises(ValueError, match="loaded"):
        convert.from_jax_params(dict(params, dec_blocks=dec), tc,
                                device="cpu")
    # a cross-attention in an encoder block
    enc = dict(params["enc_blocks"], xattn=params["dec_blocks"]["xattn"])
    with pytest.raises(KeyError, match="xattn"):
        convert.from_jax_params(dict(params, enc_blocks=enc), tc,
                                device="cpu")
    # a head of another vocabulary, a missing decoder norm
    with pytest.raises(ValueError, match="head"):
        convert.from_jax_params(dict(params, head=params["head"][:, :90]),
                                tc, device="cpu")
    with pytest.raises(ValueError, match="loaded"):
        convert.from_jax_params({k: v for k, v in params.items()
                                 if k != "dec_norm"}, tc, device="cpu")
