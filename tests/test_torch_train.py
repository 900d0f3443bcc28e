"""repro_torch's training step against the JAX package.

Losses, the schedule, the blockwise int8 codes, AdamW's update and one
train step per model family, on the CPU: the reference's parameters are
carried across with ``convert.from_jax_params(..., device="cpu")``, the
inputs are numpy arrays from a seed (the reference's own batch arrays for
the frontend families), and the port's forward takes the plain oracles
(``use_kernels=False``), as the reference's ``use_pallas=False`` does.

Tolerances, each with its reason:

- losses and the grad norm: rtol 1e-5 (f32 sums in another order over a
  few thousand terms);
- the learning rate: rtol 1e-6 (the same f32 formula; XLA's and
  PyTorch's f32 cosines may differ in the last place);
- int8 codes and block scales: exact (absmax, one correctly rounded
  division and round-half-to-even on both sides); after three updates, at
  most 0.1 % of the codes one step apart (a moment that differs in its
  last f32 bit can round to the next code) and none further;
- parameters after the optimizer: atol 2e-4 at lr 5e-3, the bound
  ``tests/test_train_integration.py`` uses for the same noise: where a
  gradient is near zero, AdamW's m / (sqrt(v) + eps) turns rounding-level
  differences in the gradient into a visible share of the step;
- f32 moments: rtol 1e-4 of the largest entry of each tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.config import ModelConfig as JConfig
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.data.pipeline import DataConfig as TData
from repro_torch.data.pipeline import SyntheticDataset as TDataset
from repro_torch.data.pipeline import make_batch as tmake_batch
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import convert
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as tts

LOSS_RTOL = 1e-5
LR_RTOL = 1e-6
PARAM_ATOL = 2e-4
MOMENT_RTOL = 1e-4
CODES_OFF_SHARE = 1e-3
SMALL = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                  vocab=97, qkv_bias=True, logit_softcap=30.0),
    "ssm": dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=0,
                vocab=97, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
                tie_embeddings=True),
    "hybrid": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                   vocab=128, ssm_state=16, ssm_head_dim=16, window=8,
                   global_layers=(0,)),
    "vlm": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                vocab=97, qkv_bias=True, tie_embeddings=True,
                frontend="vision", num_prefix_tokens=6),
    # capacity 0.5: fewer expert slots than assignments, so drops happen
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
                vocab=97, n_experts=8, top_k=2, d_expert=48,
                capacity_factor=0.5),
    "encdec": dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
                   vocab=97, act="gelu", glu=False, encoder_layers=2,
                   encoder_seq=20, frontend="audio", pos="sinusoidal"),
}
OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=20)
DATA = dict(global_batch=4, seq_len=24)


def _configs(family, **over):
    kw = dict(name=f"t-{family}", family=family, dtype="float32",
              **SMALL[family])
    kw.update(over)
    return JConfig(**kw), TConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(jbatch):
    """The reference's batch arrays as the port's tensors (the frontend
    embeddings stay bf16)."""
    out = {}
    for k, v in jbatch.items():
        v = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(torch.bfloat16) if k in ("frames", "patches") else t
    return out


def _assert_params_close(model, jparams, cfg, atol=PARAM_ATOL):
    want = convert.from_jax_params(_np(jparams), cfg, device="cpu")
    for (name, got), (_, w) in zip(model.named_parameters(),
                                   want.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=name)


# ---------------------------------- losses ----------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(rng, z_loss, masked):
    logits = (3 * rng.normal(size=(3, 11, 37))).astype(np.float32)
    labels = rng.integers(0, 37, size=(3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) < 0.6).astype(np.float32) if masked \
        else None
    want = jlosses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss=z_loss)
    got = tlosses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss=z_loss)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_cross_entropy_empty_mask_is_zero_not_nan(rng):
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    labels = np.zeros((2, 5), np.int64)
    got = tlosses.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.zeros(2, 5))
    assert got.item() == 0.0


@pytest.mark.parametrize("extra", [0, 4])
def test_next_token_loss_matches_reference(rng, extra):
    """Logits longer than the tokens (a vlm's prefix) drop the prefix
    positions before the shift, bf16 logits are taken in f32."""
    logits = rng.normal(size=(2, 9 + extra, 31)).astype(np.float32)
    tokens = rng.integers(0, 31, size=(2, 9)).astype(np.int32)
    want = jlosses.next_token_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(tokens))
    got = tlosses.next_token_loss(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# --------------------------------- optimizer --------------------------------

def test_schedule_matches_reference():
    """Warmup, the cosine decay and the floor past ``decay_steps``."""
    jc, tc = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    steps = np.array([0, 1, 2, 3, 7, 11, 19, 20, 21, 50], np.int32)
    want = np.asarray(jopt.schedule(jc, jnp.asarray(steps)))
    got = topt.schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    assert got[0] == 0.0 and got[2] == pytest.approx(OPT["lr"])
    assert got[-1] == pytest.approx(0.1 * OPT["lr"])      # the floor


@pytest.mark.parametrize("shape", [(), (1,), (256,), (300,), (7, 129),
                                   (3, 256)])
def test_int8_codes_match_reference(rng, shape):
    """``_q8`` / ``_dq8`` and the sqrt-domain pair: codes and scales
    exactly the reference's (padding to 256, an all-zero block, a block
    with a half-way value)."""
    x = np.asarray(rng.normal(size=shape), np.float32)
    if x.size >= 256:
        x.reshape(-1)[:256] = 0.0                        # a zero block
    if x.size > 256:
        x.reshape(-1)[256:258] = [127.0, 0.5]            # round half even
    v = np.asarray(np.abs(x) ** 2, np.float32)
    for q8, dq8, arr in ((jopt._q8, jopt._dq8, x),
                         (jopt._q8_sqrt, jopt._dq8_sqrt, v)):
        tq8 = getattr(topt, q8.__name__)
        tdq8 = getattr(topt, dq8.__name__)
        jq, js = q8(jnp.asarray(arr))
        tq, ts = tq8(torch.from_numpy(arr))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tdq8(tq, ts, shape).numpy(),
            np.asarray(dq8(jq, js, shape)))


@pytest.mark.parametrize("eight_bit", [False, True])
def test_update_matches_reference(rng, eight_bit):
    """Three AdamW steps over a flat dict of f32 parameters with the same
    gradients: parameters, moments (8-bit: codes and scales), the grad
    norm and the learning rate. The first gradient is large enough to
    clip."""
    shapes = {"w": (33, 40), "b": (40,), "s": (), "big": (5, 300)}
    p0 = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in
          shapes.items()}
    jcfg = jopt.AdamWConfig(eight_bit=eight_bit, **OPT)
    tcfg = topt.AdamWConfig(eight_bit=eight_bit, **OPT)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jstate, tstate = jopt.init(jp, jcfg), topt.init(tp, tcfg)
    jupdate = jax.jit(lambda g, s, p: jopt.update(g, s, p, jcfg))
    for i in range(3):
        g = {k: np.asarray((5.0 if i == 0 else 0.3) * rng.normal(size=s),
                           np.float32) for k, s in shapes.items()}
        jp, jstate, jstats = jupdate({k: jnp.asarray(v) for k, v in
                                      g.items()}, jstate, jp)
        tp, tstate, tstats = topt.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp,
            tcfg)
        np.testing.assert_allclose(tstats["grad_norm"].item(),
                                   float(jstats["grad_norm"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tstats["lr"].item(), float(jstats["lr"]),
                                   rtol=LR_RTOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
        for mom in ("m", "v"):
            got, want = tstate[mom][k], jstate[mom][k]
            if not eight_bit:
                np.testing.assert_allclose(
                    got.numpy(), np.asarray(want), rtol=0,
                    atol=MOMENT_RTOL * float(np.abs(want).max()))
                continue
            off = np.abs(got.q.numpy().astype(np.int32)
                         - np.asarray(want.q).astype(np.int32))
            assert off.max() <= 1, (k, mom)
            assert off.mean() <= CODES_OFF_SHARE, (k, mom, off.mean())
            np.testing.assert_allclose(got.scale.numpy(),
                                       np.asarray(want.scale),
                                       rtol=MOMENT_RTOL, atol=0)


# -------------------------------- train step --------------------------------

@pytest.mark.parametrize("family", list(SMALL))
def test_train_step_matches_reference(family):
    """Three steps of the reference's jitted ``make_train_step`` and of
    the port's from the same parameters on the same batches (the
    reference's ``make_batch`` arrays): loss, grad norm, lr each step,
    then the parameters and the first moments."""
    jc, tc = _configs(family)
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    data = JData(vocab=jc.vocab, **DATA)
    jstate = jts.init_state(jax.random.PRNGKey(0), jc, jo)
    model = convert.from_jax_params(_np(jstate["params"]), tc, device="cpu")
    tstate = tts.state_for(model, to)
    jstep = jax.jit(jts.make_train_step(jc, jo))
    tstep = tts.make_train_step(tc, to)
    for i in range(3):
        jbatch = jmake_batch(jc, data, i)
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, _torch_batch(jbatch))
        for k in ("loss", "grad_norm"):
            assert tm[k].dtype == torch.float32
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=LR_RTOL)
    assert tstate["params"] is model
    _assert_params_close(model, jstate["params"], tc)
    m_ref = convert.from_jax_params(_np(jstate["opt"]["m"]), tc,
                                    device="cpu")
    for name, want in m_ref.named_parameters():
        got = tstate["opt"]["m"][name.replace(".", "/")]
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=MOMENT_RTOL * float(want.abs().max()) + 1e-12,
            err_msg=name)


def test_train_step_long_sequence_matches_reference():
    """One step at 2048 tokens, where the global layer takes the blocked
    (streaming) oracle and the windowed one the banded oracle, as
    hymba-1.5b's layers do at 4096: their gradients against the
    reference's."""
    jc, tc = _configs("hybrid", n_layers=2, d_model=32, d_ff=64, vocab=64,
                      ssm_chunk=256)
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    data = JData(vocab=jc.vocab, global_batch=1, seq_len=2048)
    jstate = jts.init_state(jax.random.PRNGKey(1), jc, jo)
    model = convert.from_jax_params(_np(jstate["params"]), tc, device="cpu")
    tstate = tts.state_for(model, to)
    jbatch = jmake_batch(jc, data, 0)
    jstate, jm = jax.jit(jts.make_train_step(jc, jo))(jstate, jbatch)
    tstate, tm = tts.make_train_step(tc, to)(tstate, _torch_batch(jbatch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _assert_params_close(model, jstate["params"], tc)


def _grads_after_step(cfg, policy, batch):
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    model = tzoo.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    model.requires_grad_(True)
    return tts.value_and_grad(model, topt.named_parameters(model), batch,
                              cfg)


@pytest.mark.parametrize("family", ["hybrid", "encdec", "moe"])
def test_remat_policies_agree(family):
    """'full', 'dots' and 'none' give the same loss and gradients,
    bitwise on the CPU (a recompute repeats the same operations)."""
    _, tc = _configs(family)
    batch = tmake_batch(tc, TData(vocab=tc.vocab, **DATA), 0, device="cpu")
    loss, grads = _grads_after_step(tc, "none", batch)
    for policy in ("full", "dots"):
        l2, g2 = _grads_after_step(tc, policy, batch)
        assert torch.equal(l2, loss), policy
        for k in grads:
            assert torch.equal(g2[k], grads[k]), (policy, k)


def test_remat_runs_only_while_recording(monkeypatch):
    """Serving (no grad, or parameters not requiring grad) calls each
    block directly; a recording forward goes through the checkpoint."""
    from repro_torch.models import transformer
    _, tc = _configs("hybrid")
    calls = []
    real = transformer.ckpt.checkpoint
    monkeypatch.setattr(transformer.ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = tzoo.init(tc, device="cpu")
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
    logits, _ = tzoo.forward(model, toks, tc)
    assert not logits.requires_grad and not calls
    model.requires_grad_(True)
    with torch.no_grad():
        tzoo.forward(model, toks, tc)
    assert not calls
    logits, _ = tzoo.forward(model, toks, tc, use_kernels=False)
    assert logits.requires_grad and len(calls) == tc.n_layers


def test_grad_accum_equivalence():
    """accum=4 equals accum=1 on the same global batch (f32, mean loss),
    as ``tests/test_train_integration.py`` holds the reference."""
    _, tc = _configs("dense")
    cfg1 = dataclasses.replace(tc, accum_steps=1)
    cfg4 = dataclasses.replace(tc, accum_steps=4)
    opt = topt.AdamWConfig(**OPT)
    data = TData(vocab=tc.vocab, global_batch=8, seq_len=24)
    m1 = tzoo.init(cfg1, torch.Generator().manual_seed(1), device="cpu")
    m4 = tzoo.init(cfg1, device="cpu")
    m4.load_state_dict(m1.state_dict())
    s1, s4 = tts.state_for(m1, opt), tts.state_for(m4, opt)
    b1 = tmake_batch(cfg1, data, 0, accum=1, device="cpu")
    b4 = tmake_batch(cfg4, data, 0, accum=4, device="cpu")
    assert b4["tokens"].shape == (4, 2, 24)
    s1, r1 = tts.make_train_step(cfg1, opt)(s1, b1)
    s4, r4 = tts.make_train_step(cfg4, opt)(s4, b4)
    assert r4["loss"].item() == pytest.approx(r1["loss"].item(), rel=1e-5)
    diff = max((a - b).abs().max().item() for a, b in
               zip(m1.parameters(), m4.parameters()))
    assert diff < PARAM_ATOL


# ----------------------------------- data -----------------------------------

@pytest.mark.parametrize("seed,vocab", [(0, 97), (3, 32001), (12345, 7)])
def test_tokens_bitwise_equal_reference(seed, vocab):
    jd = JDataset(JData(vocab=vocab, global_batch=6, seq_len=40, seed=seed))
    td = TDataset(TData(vocab=vocab, global_batch=6, seq_len=40, seed=seed))
    for step in (0, 1, 7, 1000, 2 ** 31 - 1):
        np.testing.assert_array_equal(td.local_batch(step),
                                      jd.local_batch(step))
        np.testing.assert_array_equal(td.tokens_slice(step, 2, 5, 10, 33),
                                      jd.tokens_slice(step, 2, 5, 10, 33))
    assert td.local_batch(0).dtype == np.int32


@pytest.mark.parametrize("family", ["dense", "vlm", "encdec"])
@pytest.mark.parametrize("accum", [1, 2])
def test_make_batch_matches_reference_layout(family, accum):
    """Tokens equal the reference's; the frontend embeddings have its key,
    shape and dtype (their values come from a torch generator) and are
    the same on every call."""
    jc, tc = _configs(family)
    want = jmake_batch(jc, JData(vocab=jc.vocab, **DATA), 5, accum=accum)
    got = tmake_batch(tc, TData(vocab=tc.vocab, **DATA), 5, accum=accum,
                      device="cpu")
    again = tmake_batch(tc, TData(vocab=tc.vocab, **DATA), 5, accum=accum,
                        device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    for k in set(got) - {"tokens"}:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        assert torch.equal(got[k], again[k])
        assert 0.01 < got[k].float().std().item() < 0.03


# ------------------------------ the plain route -----------------------------

def test_use_kernels_rules(monkeypatch, rng):
    """``use_kernels=True`` off the card raises; on the card (patched
    here: the check precedes any launch) a kernel call whose inputs
    autograd records raises, and ``use_kernels=False`` takes the plain
    oracles, which carry gradients."""
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(
        np.float32)) for _ in range(3))
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.attention(q, k, v, use_kernels=True)
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    a = -torch.rand(1, 8, 2)
    bc = torch.from_numpy(rng.normal(size=(1, 8, 2, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.ssd(x, a, bc, bc, use_kernels=True)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(qg, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x.clone().requires_grad_(True), a, bc, bc)
    out = ops.attention(qg, k, v, use_kernels=False)
    assert torch.equal(out, ref.attention(q, k, v))
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    y = ops.ssd(x, a, bc, bc, chunk=4, use_kernels=False)
    assert torch.equal(y, ref.ssd_chunked(x, a, bc, bc, chunk=4))
