"""The port's sharding rules against the JAX package's, in process.

Every registered config at full width: the port's model built on the
``meta`` device (no storage), the reference's shapes from
``jax.eval_shape``; ``params_specs`` / ``state_specs`` / ``batch_specs`` /
``cache_specs`` compared on the reference's five meshes of the dry run and
the tests (16 x 16, 2 x 16 x 16, 2 x 4, 4 x 2, 1 x 1: a ``jax.sharding.
AbstractMesh`` there, a plain ``{axis: size}`` mapping here, no devices).
The port keys each layer where the reference stacks them, so a port
leaf's spec is the reference's without its leading layer ``None``; an
8-bit moment quantizes one layer in the port and the stack in the
reference, so where the code shapes differ the port's spec is the same
rule on its own shape (asserted, and the differing leaves counted).

Then the placements of a spec (a multi-axis entry included), this rank's
block under them, the undivided vocab of hymba-1.5b, and the identity
``shard_fn`` leaving one-device results bitwise as they were.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jreg
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import registry
from repro_torch.distributed import sharding as sh
from repro_torch.models import convert, model_zoo
from repro_torch.models.config import ModelConfig
from repro_torch.train import train_state as ts
from repro_torch.train.optimizer import AdamWConfig, Q_BLOCK

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
CACHE_BATCH, CACHE_LEN = 32, 256          # divide every mesh's axes


def _key(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "name"):
        return "." + str(p.name)
    return str(p.idx)


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(_key(k) for k in path): tuple(v) for path, v in flat}


def _flat_port(tree, prefix=""):
    if isinstance(tree, sh.P):
        return {prefix: tuple(tree)}
    if hasattr(tree, "_fields"):
        items = [("." + f, v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = [(str(i), v) for i, v in enumerate(tree)]
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _ref_key(port_key: str) -> str:
    """``params/blocks/3/attn/wq`` -> ``params/blocks/attn/wq``."""
    split = convert._split_stack(port_key)
    if split is None:
        return port_key
    head, _, rest = split
    return f"{head}/{rest}"


@pytest.fixture(scope="module")
def shapes():
    """Per config: the reference's abstract state, params and caches, and
    the port's meta model, state and caches."""
    out = {}
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        jcfg = jreg.get_config(arch)
        jstate = jax.eval_shape(lambda k: jts.init_state(
            k, jcfg, JAdamW(eight_bit=jcfg.opt_8bit)), key)
        model = model_zoo.build(cfg, "meta")
        state = ts.state_for(model, AdamWConfig(eight_bit=cfg.opt_8bit))
        if cfg.family == "encdec":
            mem = jax.ShapeDtypeStruct((CACHE_BATCH, cfg.encoder_seq,
                                        cfg.d_model), jnp.bfloat16)
            jcaches = jax.eval_shape(lambda p, m: jzoo.init_caches(
                p, jcfg, CACHE_BATCH, CACHE_LEN, memory=m),
                jstate["params"], mem)
            caches = model_zoo.init_caches(
                model, cfg, CACHE_BATCH, CACHE_LEN,
                memory=torch.empty(mem.shape, dtype=torch.bfloat16,
                                   device="meta"))
        else:
            jcaches = jax.eval_shape(lambda p: jzoo.init_caches(
                p, jcfg, CACHE_BATCH, CACHE_LEN), jstate["params"])
            caches = model_zoo.init_caches(model, cfg, CACHE_BATCH,
                                           CACHE_LEN)
        out[arch] = (jstate, state, jcaches, caches)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_state_specs_match_reference(shapes, arch, mesh):
    """params_specs / state_specs leaf for leaf: the reference's spec
    without its leading layer None for a stacked leaf; an 8-bit moment's
    codes the same rule on the port's own (per-layer) block count."""
    jstate, state, _, _ = shapes[arch]
    jmesh = AbstractMesh(*mesh)
    pmesh = dict(zip(mesh[1], mesh[0]))
    want = _flat_ref(jsh.state_specs(jstate, jmesh))
    got = _flat_port(sh.state_specs(state, pmesh))
    assert {_ref_key(k) for k in got} == set(want)
    want_params = _flat_ref(jsh.params_specs(jstate["params"], jmesh))
    got_params = _flat_port(sh.params_specs(state["params"], pmesh),
                            "params")
    assert got_params == {k: v for k, v in got.items()
                          if k.startswith("params/")}
    dp = sh.batch_axes(pmesh)
    ndp = sh.dp_size(pmesh)
    apart = 0
    for k, spec in got.items():
        ref = want[_ref_key(k)]
        stacked = _ref_key(k) != k
        if k.endswith("/.q"):                # an 8-bit moment's codes
            blocks = state["opt"][k.split("/")[1]][
                k.split("/", 2)[2][:-len("/.q")]].q.shape[0]
            rule = sh.P(dp if dp and ndp > 1 and blocks % ndp == 0
                        else None, None)
            assert spec == rule, k
            if not stacked:
                assert spec == ref, k
            apart += spec != ref
            continue
        if k.endswith("/.scale"):
            assert spec == ref == (None, None), k
            continue
        if stacked:
            assert ref[0] is None, k
            ref = ref[1:]
        assert spec == ref, (k, spec, ref)
    if not registry.get_config(arch).opt_8bit:
        assert apart == 0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_cache_and_batch_specs_match_reference(shapes, arch, mesh):
    """cache_specs on the decode caches (stacked on the same leading layer
    axis on both sides, hybrid's per-layer lists), batch_specs on a
    divisible and a ragged batch, with and without accumulation."""
    _, _, jcaches, caches = shapes[arch]
    jmesh = AbstractMesh(*mesh)
    pmesh = dict(zip(mesh[1], mesh[0]))
    assert _flat_port(sh.cache_specs(caches, pmesh)) == \
        _flat_ref(jsh.cache_specs(jcaches, jmesh))
    assert _flat_port(sh.cache_specs(caches, pmesh, seq_shard=False)) == \
        _flat_ref(jsh.cache_specs(jcaches, jmesh, seq_shard=False))
    for b, accum in ((256, 1), (6, 1), (256, 4)):
        shape = (b, 128) if accum == 1 else (accum, b // accum, 128)
        want = _flat_ref(jsh.batch_specs(
            {"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}, jmesh,
            accum=accum))
        got = _flat_port(sh.batch_specs({"tokens": shape}, pmesh,
                                        accum=accum))
        assert got == want, (b, accum)


def test_eight_bit_block_dims_differ_only_where_documented(shapes):
    """kimi-k2 (8-bit moments): each port moment codes one layer's
    parameter in ceil(n / 256) blocks, the reference's the stack of L
    layers in ceil(L n / 256); outside the stacks the shapes are equal."""
    jstate, state, _, _ = shapes["kimi-k2-1t-a32b"]
    cfg = registry.get_config("kimi-k2-1t-a32b")
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate["opt"]["m"])
    jq = {"/".join(_key(k) for k in p[:-1]): tuple(leaf.shape)
          for p, leaf in flat if _key(p[-1]) == ".q"}
    stacked = 0
    for path, m in state["opt"]["m"].items():
        n = int(np.prod(state["params"].get_parameter(
            path.replace("/", ".")).shape))
        assert tuple(m.q.shape) == (-(-n // Q_BLOCK), Q_BLOCK), path
        ref_path = _ref_key("params/" + path)[len("params/"):]
        if ref_path == path:
            assert tuple(m.q.shape) == jq[ref_path], path
        else:
            stacked += 1
            assert jq[ref_path] == (-(-cfg.n_layers * n // Q_BLOCK),
                                    Q_BLOCK), path
    assert stacked > 0


def test_placements_of_specs():
    """An axis in entry i is Shard(i) on its mesh dim; a tuple entry is
    Shard(i) on each of its dims, in mesh order; the rest Replicate."""
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert sh.spec_placements(sh.P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.spec_placements(sh.P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sh.spec_placements(sh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        sh.spec_placements(sh.P(("data", "pod")), mesh)


class _Coord:
    """A stand-in mesh for :func:`sh.local_index` (a coordinate, sizes)."""

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)


def test_local_blocks_nest_row_major():
    """A dim sharded over (pod, data) splits row-major, pod major; the
    blocks of all ranks tile the tensor once."""
    shape, pl = (8, 6), (Shard(0), Shard(0), Shard(1))
    seen = np.zeros(shape, int)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                idx = sh.local_index(shape, pl, _Coord((2, 2, 3), (p, d, m)))
                assert idx[0] == slice(2 * (2 * p + d), 2 * (2 * p + d) + 2)
                seen[idx] += 1
    assert (seen == 1).all()


def test_undivided_dims_stay_replicated():
    """hymba-1.5b's vocab 32001 divides no model axis: table and head stay
    whole over "model" and ZeRO takes their d = 1600 over "data"."""
    cfg = registry.get_config("hymba-1.5b")
    specs = sh.params_specs(model_zoo.build(cfg, "meta"),
                            {"data": 2, "model": 2})
    assert specs["embed/table"] == (None, "data")
    assert specs["head"] == ("data", None)
    assert specs["blocks/0/mix/attn/wq"] == ("data", "model")
    assert sh.param_spec("embed/table", (30, 7), {"data": 4, "model": 4}) \
        == sh.P(None, None)


SMALL = ModelConfig("t", "dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                    d_ff=128, vocab=97, dtype="float32")


def test_identity_shard_fn_is_bitwise_and_placed_as_the_reference():
    """The hook a (1, 1) mesh makes leaves a one-device forward, decode
    and train step bitwise what the default gives; a recording hook sees
    the reference's call sites (after the embedding, after each block's
    mixer and at its end; decode: after the embedding and each block)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    hook = sh.make_shard_fn({"data": 1, "model": 1})
    calls = []

    def record(x, name):
        calls.append(name)
        return x

    batch = make_batch(SMALL, DataConfig(97, 4, 16), 0, device="cpu")
    model = model_zoo.init(SMALL, torch.Generator().manual_seed(0), "cpu")
    base, _ = model_zoo.forward(model, batch, SMALL)
    for fn in (hook, record):
        got, _ = model_zoo.forward(model, batch, SMALL, shard_fn=fn)
        assert torch.equal(got, base)
    assert calls == ["residual"] * (1 + 2 * SMALL.n_layers)
    caches = model_zoo.init_caches(model, SMALL, 4, 8, dtype=torch.float32)
    want, _ = model_zoo.decode_step(model, batch["tokens"][:, :1], SMALL,
                                    caches, 0)
    caches = model_zoo.init_caches(model, SMALL, 4, 8, dtype=torch.float32)
    calls.clear()
    got, _ = model_zoo.decode_step(model, batch["tokens"][:, :1], SMALL,
                                   caches, 0, shard_fn=record)
    assert torch.equal(got, want) and len(calls) == 1 + SMALL.n_layers
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=50)
    states = [ts.init_state(torch.Generator().manual_seed(0), SMALL, opt,
                            "cpu") for _ in range(2)]
    _, m0 = ts.make_train_step(SMALL, opt)(states[0], batch)
    _, m1 = ts.make_train_step(SMALL, opt, hook)(states[1], batch)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(states[0]["params"].parameters(),
                    states[1]["params"].parameters()):
        assert torch.equal(a, b)


def test_model_axis_residual_raises_where_it_would_split():
    hook = sh.make_shard_fn({"data": 2, "model": 2},
                            model_axis_residual=True)
    with pytest.raises(ValueError):
        hook(torch.zeros(2, 3, 64), "residual")
    x = torch.zeros(2, 3, 63)                      # d does not divide
    assert hook(x, "residual") is x


def test_train_state_rules_on_a_reduced_config_count_the_bytes():
    """spec_bytes: each leaf's bytes over the sizes of the axes its spec
    names (a reduced hymba at (2, 2): every big matrix quartered)."""
    from repro_torch.launch.train import reduce_config
    cfg = dataclasses.replace(reduce_config(
        registry.get_config("hymba-1.5b"), layers=2, d_model=64, vocab=128,
        heads=4), dtype="float32")
    state = ts.state_for(model_zoo.build(cfg, "meta"), AdamWConfig())
    whole = sum(p.numel() * 4 for p in state["params"].parameters())
    got = sh.spec_bytes(state, {"data": 2, "model": 2})
    assert whole // 4 * 3 <= got < 3 * whole
    assert sh.spec_bytes(state, {"data": 1, "model": 1}) == 3 * whole + 4


# the moe's capacity slots on the production meshes (the dry run's cells):
# an expert's capacity padded to a multiple of the DP ranks, where it is
# not one already (the capacity is a multiple of 8, so only at 16 and 32)
MOE_ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
MOE_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DP_RANKS = {"pod": 16, "multipod": 32}
PADDED = {("kimi-k2-1t-a32b", "train_4k", "pod"): (3416, 3424),
          ("kimi-k2-1t-a32b", "train_4k", "multipod"): (3416, 3424),
          ("kimi-k2-1t-a32b", "decode_32k", "pod"): (8, 16),
          ("kimi-k2-1t-a32b", "decode_32k", "multipod"): (8, 32),
          ("kimi-k2-1t-a32b", "prefill_32k", "multipod"): (27312, 27328),
          ("qwen3-moe-235b-a22b", "decode_32k", "multipod"): (16, 32)}


@pytest.mark.parametrize("mesh", sorted(DP_RANKS))
@pytest.mark.parametrize("arch,shape", [(a, s) for a in MOE_ARCHS
                                        for s in MOE_SHAPES])
def test_moe_capacity_padding_and_windows(arch, shape, mesh):
    """``padded_capacity`` and ``slot_window`` at the moe cells' global
    token counts (a microbatch's in training): the capacity padded only
    in the six cells listed, to the next multiple of the DP ranks; the
    ranks' windows the same size, disjoint, covering the padded slots in
    flat order."""
    from repro_torch.models.moe import capacity, padded_capacity, \
        slot_window
    cfg = registry.get_config(arch)
    spec = registry.SHAPE_BY_NAME[shape]
    tokens = spec.global_batch * (1 if spec.kind == "decode"
                                  else spec.seq_len)
    if spec.kind == "train":
        tokens //= cfg.accum_steps
    n = DP_RANKS[mesh]
    cap = capacity(tokens, cfg)
    pad = padded_capacity(cap, n)
    assert (cap, pad) == PADDED.get((arch, shape, mesh), (cap, cap))
    assert pad % n == 0 and 0 <= pad - cap < n
    windows = [slot_window(cap, n, i) for i in range(n)]
    assert [w.start for w in windows] == [i * pad // n for i in range(n)]
    assert all(w.stop - w.start == pad // n for w in windows)
    assert windows[-1].stop == pad
