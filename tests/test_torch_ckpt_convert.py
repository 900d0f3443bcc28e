"""Train-state checkpoints that cross packages.

A reference train state (``repro.ckpt.save``: layers stacked, 8-bit
moments keyed ``.../.q`` and ``.../.scale``) is carried into the port with
``convert.train_state_from_jax`` and restored by the port's
``ckpt.restore``; the port's goes back with ``train_state_to_jax`` and is
restored by the reference. Reduced hybrid and dense states, with f32 and
8-bit moments, each after one step so the moments are not zero.

Tolerances, each with its reason:

- f32 leaves: bitwise (the conversion only splits and stacks arrays);
- 8-bit moments whose layers hold whole 256-value blocks: bitwise (the
  stack's blocks are the layers' blocks);
- the other 8-bit moments are requantized: each value within half a code
  step of its new block's scale of the value the other package's file
  codes (round to nearest), plus f32 rounding of values up to 127 steps
  (``HALF_STEP``); after the round trip, within half a step of each of the
  two codings;
- the step after a restore against the other package's step from the
  same state: loss and grad norm rtol 1e-5, parameters atol 2e-4 with f32
  moments (``chip_smoke.py``'s ``TRAIN_TOL``, the bound
  ``tests/test_train_integration.py`` uses). With 8-bit moments the
  restored moments are the other's within the bound above, so the step's
  parameters differ more: readings 2.0e-4 (dense) and 5.8e-4 (hybrid), a
  requantized v near its floor; ``PARAM_ATOL_8BIT`` 1.5e-3 is under the
  update itself (median 4.7e-3 at this step), so a skipped or halved
  update fails. The moments after the step are held to the other's
  within one code step of each coding (``MOMENT_STEPS``): each side
  rounds its own by half a step, and the restored moments they start from
  differ by up to half a step (readings: 0.63 of the bound).
"""
import functools
import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.config import ModelConfig as JConfig
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.ckpt import checkpoint as ck
from repro_torch.models import convert
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.train import optimizer as topt
from repro_torch.train import train_state as tts

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4
OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=20)
PARAM_ATOL_8BIT = 1.5e-3
HALF_STEP = 0.5 + 1e-4
MOMENT_STEPS = 1.0
SMALL = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                  vocab=97, qkv_bias=True),
    "hybrid": dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                   vocab=128, ssm_state=16, ssm_head_dim=16, window=8,
                   global_layers=(0,)),
}
CASES = [(f, e) for f in SMALL for e in (False, True)]
DATA = dict(global_batch=4, seq_len=24)


def _setup(family, eight_bit):
    kw = dict(name=f"t-{family}", family=family, dtype="float32",
              **SMALL[family])
    jc, tc = JConfig(**kw), TConfig(**kw)
    jo = jopt.AdamWConfig(eight_bit=eight_bit, **OPT)
    to = topt.AdamWConfig(eight_bit=eight_bit, **OPT)
    return jc, tc, jo, to, JData(vocab=jc.vocab, **DATA)


def _torch_batch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def _npz(directory, step):
    with np.load(os.path.join(directory, f"step_{step:010d}",
                              "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


def _port_like(tc, to):
    return tts.state_for(tzoo.build(tc, "cpu"), to)


def _port_flat(state):
    return {k: v.detach().numpy() for k, v in ck._flatten(state).items()}


def _ref_flat(jstate):
    return {k: np.asarray(v) for k, v in jck._flatten(jstate).items()}


def _convert_quiet(fn, flat):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(flat)


@functools.lru_cache(maxsize=None)
def _ref_state_after_one_step(family, eight_bit):
    """The reference's state after one step and its jitted step, once per
    case for the module (the step compiles once; jax arrays are
    immutable, so the tests share them)."""
    jc, _, jo, _, data = _setup(family, eight_bit)
    jstate = jts.init_state(jax.random.PRNGKey(0), jc, jo)
    jstep = jax.jit(jts.make_train_step(jc, jo))
    jstate, _ = jstep(jstate, jmake_batch(jc, data, 0))
    return jstate, jstep


def _assert_step_close(tm, jm, model, jparams, tc, atol):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tc,
                                   device="cpu")
    for (name, got), (_, w) in zip(model.named_parameters(),
                                   want.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _whole_blocks(flat_ref, key):
    """Does every layer of the moment at reference key ``key`` (ending in
    ``/.q`` or ``/.scale``) hold whole 256-value blocks?"""
    shape = flat_ref[convert._param_key(key)].shape
    return int(np.prod(shape[1:])) % convert.Q_BLOCK == 0


def _steps(scale, n):
    """Each of ``n`` values' code step: its block's scale."""
    return np.repeat(scale.reshape(-1), convert.Q_BLOCK)[:n]


def _check_codes(got_q, got_s, want, n, slack=0.0):
    """The ``n`` values an 8-bit coding holds are within half a code step
    of its block scale (plus ``slack``, per value) of ``want``."""
    err = np.abs(convert._codes_value(got_q, got_s, n) - want)
    bound = HALF_STEP * _steps(got_s, n) + slack
    assert np.all(err <= bound), np.max(err - bound)


def _stack_values(flat, base, layers, n):
    """The (layers, n) values of a port moment keyed per layer, and their
    code steps."""
    head, rest = base.split("/blocks/", 1)
    qs = [flat[f"{head}/blocks/{i}/{rest}/.q"] for i in range(layers)]
    ss = [flat[f"{head}/blocks/{i}/{rest}/.scale"] for i in range(layers)]
    return (np.stack([convert._codes_value(q, s, n) for q, s in zip(qs, ss)]),
            np.stack([_steps(s, n) for s in ss]))


def _assert_moments_close(port_flat, ref_flat):
    """Every 8-bit moment after a step in each package holds the same
    values within ``MOMENT_STEPS`` code steps of each of the two codings."""
    for key in [k for k in ref_flat if k.endswith("/.q")]:
        base = key[:-len("/.q")]
        shape = ref_flat[convert._param_key(key)].shape
        if convert._is_stacked(key):
            layers, n = shape[0], int(np.prod(shape[1:]))
            got, got_step = _stack_values(port_flat, base, layers, n)
        else:
            layers, n = 1, int(np.prod(shape))
            got = convert._codes_value(port_flat[key],
                                       port_flat[base + "/.scale"], n)
            got_step = _steps(port_flat[base + "/.scale"], n)
        scale = ref_flat[base + "/.scale"]
        want = convert._codes_value(ref_flat[key], scale, layers * n)
        err = np.abs(got.reshape(-1) - want)
        bound = MOMENT_STEPS * (got_step.reshape(-1)
                                + _steps(scale, layers * n))
        assert np.all(err <= bound), (key, np.max(err - bound))


@pytest.mark.parametrize("family,eight_bit", CASES)
def test_reference_checkpoint_restores_into_port(family, eight_bit):
    """repro.ckpt.save of the reference's state -> train_state_from_jax ->
    the port's restore -> one port step against the reference's next."""
    jc, tc, jo, to, data = _setup(family, eight_bit)
    jstate, jstep = _ref_state_after_one_step(family, eight_bit)
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_port:
        jck.save(d_ref, 1, jstate)
        flat_ref = _npz(d_ref, 1)
        conv = _convert_quiet(convert.train_state_from_jax, flat_ref)
        ck.save(d_port, 1, conv)
        state, step = ck.restore(d_port, _port_like(tc, to))
    assert step == 1 and int(state["opt"]["step"]) == 1
    if eight_bit:
        assert isinstance(state["opt"]["m"]["embed/table"], topt._Moment)
    batch = jmake_batch(jc, data, 1)
    jstate, jm = jstep(jstate, batch)
    state, tm = tts.make_train_step(tc, to)(state, _torch_batch(batch))
    _assert_step_close(tm, jm, state["params"], jstate["params"], tc,
                       PARAM_ATOL_8BIT if eight_bit else PARAM_ATOL)
    if eight_bit:
        _assert_moments_close(_port_flat(state), _ref_flat(jstate))


@pytest.mark.parametrize("family,eight_bit", CASES)
def test_port_checkpoint_restores_into_reference(family, eight_bit):
    """The port's state after one step -> ck.save -> train_state_to_jax ->
    repro.ckpt.restore -> one reference step against the port's next."""
    jc, tc, jo, to, data = _setup(family, eight_bit)
    jparams = jts.init_state(jax.random.PRNGKey(0), jc, jo)["params"]
    model = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tc,
                                    device="cpu")
    state = tts.state_for(model, to)
    tstep = tts.make_train_step(tc, to)
    state, _ = tstep(state, _torch_batch(jmake_batch(jc, data, 0)))
    like = jts.init_state(jax.random.PRNGKey(1), jc, jo)
    with tempfile.TemporaryDirectory() as d_port, \
            tempfile.TemporaryDirectory() as d_ref:
        ck.save(d_port, 1, state)
        conv = _convert_quiet(convert.train_state_to_jax, _npz(d_port, 1))
        jck.save(d_ref, 1, conv)
        jstate, step = jck.restore(d_ref, like)
    assert step == 1 and int(jstate["opt"]["step"]) == 1
    batch = jmake_batch(jc, data, 1)
    jstate, jm = _ref_state_after_one_step(family, eight_bit)[1](jstate,
                                                                 batch)
    state, tm = tstep(state, _torch_batch(batch))
    _assert_step_close(tm, jm, state["params"], jstate["params"], tc,
                       PARAM_ATOL_8BIT if eight_bit else PARAM_ATOL)
    if eight_bit:
        _assert_moments_close(_port_flat(state), _ref_flat(jstate))


@pytest.mark.parametrize("family", list(SMALL))
def test_f32_conversion_is_bitwise(family):
    """f32 moments: every leaf splits into the port's keys bitwise, and
    back again to the reference's file bit for bit."""
    jc, tc, jo, to, data = _setup(family, False)
    jstate, _ = _ref_state_after_one_step(family, False)
    flat_ref = _ref_flat(jstate)
    conv = convert.train_state_from_jax(flat_ref)
    assert set(conv) == set(_port_flat(_port_like(tc, to)))
    for key, arr in conv.items():
        split = convert._split_stack(key)
        if split is None:
            want = flat_ref[key]
        else:
            head, layer, rest = split
            want = flat_ref[f"{head}/{rest}"][layer]
        assert arr.dtype == want.dtype and np.array_equal(arr, want), key
    back = convert.train_state_to_jax(conv)
    assert set(back) == set(flat_ref)
    for key, want in flat_ref.items():
        assert back[key].dtype == want.dtype
        assert np.array_equal(back[key], want), key


@pytest.mark.parametrize("family", list(SMALL))
def test_eight_bit_conversion_bitwise_on_whole_blocks(family):
    """8-bit moments: bitwise where each layer holds whole 256-value
    blocks, requantized within half a code step of the reference's values
    elsewhere (both directions); the reduced configs have both kinds
    (d_model 64 norms: 64 values a layer), and the straddling ones are
    named in a warning."""
    jc, tc, jo, to, data = _setup(family, True)
    jstate, _ = _ref_state_after_one_step(family, True)
    flat_ref = _ref_flat(jstate)
    with pytest.warns(UserWarning, match="requantized"):
        conv = convert.train_state_from_jax(flat_ref)
    qkeys = [k for k in flat_ref if k.endswith("/.q")
             and convert._is_stacked(k)]
    whole = [k for k in qkeys if _whole_blocks(flat_ref, k)]
    assert whole and len(whole) < len(qkeys)
    with pytest.warns(UserWarning, match="requantized"):
        back = convert.train_state_to_jax(conv)
    assert set(back) == set(flat_ref)
    for key in qkeys:
        base = key[:-len("/.q")]
        head, rest = base.split("/blocks/", 1)
        shape = flat_ref[convert._param_key(key)].shape
        layers, n = shape[0], int(np.prod(shape[1:]))
        want = convert._codes_value(flat_ref[key], flat_ref[base + "/.scale"],
                                    layers * n)
        for layer in range(layers):
            q = conv[f"{head}/blocks/{layer}/{rest}/.q"]
            s = conv[f"{head}/blocks/{layer}/{rest}/.scale"]
            assert q.dtype == np.int8 and s.dtype == np.float32
            if key in whole:
                nb = n // convert.Q_BLOCK
                assert np.array_equal(
                    q, flat_ref[key][layer * nb:(layer + 1) * nb]), key
                assert np.array_equal(
                    s, flat_ref[base + "/.scale"][layer * nb:
                                                  (layer + 1) * nb]), key
            else:
                _check_codes(q, s, want.reshape(layers, n)[layer], n)
        if key in whole:
            assert np.array_equal(back[key], flat_ref[key]), key
            assert np.array_equal(back[base + "/.scale"],
                                  flat_ref[base + "/.scale"]), key
        else:
            # the round trip: half a step of the port's coding, then of
            # the new stacked coding
            _, port_step = _stack_values(conv, base, layers, n)
            _check_codes(back[key], back[base + "/.scale"], want, layers * n,
                         slack=HALF_STEP * port_step.reshape(-1))


def test_ragged_layers_requantize_within_one_step(rng):
    """A stack whose layers (3 x 100 values) are not whole blocks: the
    reference's 2 blocks straddle the layers; each port layer gets one
    block of its own, within half a code step of the reference's values,
    and the round trip within half a step of each coding."""
    p = rng.normal(size=(3, 10, 10)).astype(np.float32)
    m = rng.normal(size=(3, 10, 10)).astype(np.float32)
    q, s = (np.asarray(a) for a in jopt._q8(jnp.asarray(m)))
    assert q.shape == (2, 256)
    want = convert._codes_value(q, s, 300)
    flat_ref = {"params/blocks/w": p, "opt/step": np.asarray(3, np.int32),
                "opt/m/blocks/w/.q": q, "opt/m/blocks/w/.scale": s}
    with pytest.warns(UserWarning, match="1 8-bit moments"):
        conv = convert.train_state_from_jax(flat_ref)
    for layer in range(3):
        lq = conv[f"opt/m/blocks/{layer}/w/.q"]
        assert lq.shape == (1, 256)
        _check_codes(lq, conv[f"opt/m/blocks/{layer}/w/.scale"],
                     want.reshape(3, 100)[layer], 100)
        np.testing.assert_array_equal(conv[f"params/blocks/{layer}/w"],
                                      p[layer])
    with pytest.warns(UserWarning, match="requantized"):
        back = convert.train_state_to_jax(conv)
    _, port_step = _stack_values(conv, "opt/m/blocks/w", 3, 100)
    _check_codes(back["opt/m/blocks/w/.q"], back["opt/m/blocks/w/.scale"],
                 want, 300, slack=HALF_STEP * port_step.reshape(-1))
    assert back["opt/step"] == 3


def test_moment_keys_are_the_references():
    """The port writes an 8-bit moment as ``.../.q`` / ``.../.scale``, the
    reference's GetAttrKey spelling, for the same named-tuple tree."""
    codes = np.arange(256, dtype=np.int8).reshape(1, 256)
    scale = np.ones((1, 1), np.float32)
    jtree = {"m": {"w": jopt._Moment(jnp.asarray(codes),
                                     jnp.asarray(scale))}}
    ttree = {"m": {"w": topt._Moment(torch.from_numpy(codes),
                                     torch.from_numpy(scale))}}
    assert sorted(ck._flatten(ttree)) == sorted(jck._flatten(jtree)) \
        == ["m/w/.q", "m/w/.scale"]


@pytest.mark.parametrize("eight_bit", [False, True])
def test_unconverted_foreign_file_raises(eight_bit):
    """Neither package restores the other's train state unconverted."""
    jc, tc, jo, to, data = _setup("dense", eight_bit)
    jstate = jts.init_state(jax.random.PRNGKey(0), jc, jo)
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, 1, jstate)
        with pytest.raises(KeyError, match="missing keys"):
            ck.restore(d, _port_like(tc, to))
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, _port_like(tc, to))
        with pytest.raises(KeyError, match="missing keys"):
            jck.restore(d, jstate)
