"""The port's sharded trainer against the JAX package's: DP x TP x ZeRO
state on DTensor, sharded batches, decode, the pipeline, elastic restore,
checkpoints across packages and ``train_loop(mesh=...)`` with a restart.

One module-scoped run does every case on both sides, from the same numpy
inputs (the reference's initial parameters are drawn here, in process, by
its own ``init_state``): the reference in a subprocess with 8 fake host
devices (``XLA_FLAGS``, as ``tests/test_distributed.py`` runs it, every
step jitted), the port as 8 gloo CPU ranks
(``tests/test_torch_shard_worker.py``). The cases are the reference's own
tests' (``tests/test_distributed.py``): a dense 2-layer model's train step
and decode on a 2 x 4 mesh, 4 pipeline stages of affine maps, elastic
1 x 1 -> 4 x 2; and a moe model's train step on 2 x 4 at the registered
capacity factor, tokens dropped. The products run tensor-parallel over
"model" (Megatron column and row products, attention on each rank's
heads): the dense model's n_kv 2 on model 4 gathers the kv heads'
columns; three more models' steps hold the other TP routes (a vocabulary
that divides the model axis: vocab-parallel embedding, head and loss; a
hybrid whose 5 attention heads do not divide it and whose 8 SSM heads
do, mamba by head; an encoder-decoder), and the vocab-split model's
prefill and decode; the TP ops themselves are held to the unsplit
products in float64 (gradients within 1e-12). The port alone (no
reference side) runs a Mamba-2 block by head in each route of its
in_proj columns against one device, and an ssm model's decode on the
state's head blocks.

Tolerances (``tests/test_torch_train.py``'s, for the same noise): losses
and grad norms rtol 1e-5, the learning rate 1e-6, parameters atol 2e-4 at
lr 5e-3 (f32 moments, and 8-bit ones where each layer holds whole
256-value blocks); 8-bit codes at most 0.1 % one step apart and none
further, compared where each layer holds whole blocks (elsewhere the
port's per-layer blocks and the reference's stacked ones code other
values, and the parameters are held to 2 lr a step, the update's size
where v sits at its floor); decode logits atol 2e-3 (the reference
test's); the pipeline atol 1e-4 of the reference's (its test's) and
bitwise the stages run in order; global batches, elastic restores and
checkpoints bitwise; a restarted ``train_loop`` within rtol 1e-4 of the
uninterrupted one (the trainer's resume bound).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.models.config import ModelConfig as JConfig
from repro.train import train_state as jts
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.models import convert
from repro_torch.train.optimizer import Q_BLOCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
TIMEOUT = 600
LOSS_RTOL, LR_RTOL, PARAM_ATOL = 1e-5, 1e-6, 2e-4
CODES_OFF_SHARE = 1e-3
EIGHT_BIT_ATOL = 2 * 2 * 5e-3           # 2 steps x 2 lr (see the test)
DECODE_ATOL = 2e-3
PIPE_ATOL = 1e-4
RESUME_RTOL = 1e-4
SPEC = {
    "cfg": dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv=2, d_ff=128, vocab=97, dtype="float32"),
    "cfg_decode": dict(name="t", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv=4, d_ff=128, vocab=97,
                       dtype="float32"),
    "cfg_moe": dict(name="t", family="moe", n_layers=2, d_model=64,
                    n_heads=4, n_kv=2, d_ff=96, vocab=97, n_experts=8,
                    top_k=2, d_expert=48, capacity_factor=1.25,
                    dtype="float32"),
    # each batch row its own group (8 slots an expert: tokens dropped)
    "cfg_moe_grouped": dict(name="t", family="moe", n_layers=2, d_model=64,
                            n_heads=4, n_kv=2, d_ff=96, vocab=97,
                            n_experts=8, top_k=2, d_expert=48,
                            capacity_factor=0.5, moe_grouped=True,
                            dtype="float32"),
    # TP over "model" of 4: the vocabulary divides it (vocab-parallel
    # embedding, head and loss); the hybrid's 5 heads do not (q, k and v
    # gathered) and its in_proj's 280 columns do; whisper's layout
    "cfg_vocab": dict(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv=2, d_ff=128, vocab=96,
                      dtype="float32"),
    "cfg_hybrid": dict(name="t", family="hybrid", n_layers=2, d_model=64,
                       n_heads=5, n_kv=1, head_dim=16, d_ff=128, vocab=96,
                       ssm_state=8, ssm_head_dim=16, ssm_expand=2,
                       ssm_groups=1, ssm_chunk=16, window=8,
                       global_layers=(0,), dtype="float32"),
    "cfg_encdec": dict(name="t", family="encdec", n_layers=2, d_model=64,
                       n_heads=4, n_kv=4, d_ff=128, vocab=96,
                       encoder_layers=2, encoder_seq=16, frontend="audio",
                       pos="sinusoidal", act="gelu", glu=False,
                       dtype="float32"),
    # the port-only Mamba-2 case (no reference side): 8 SSM heads, which
    # divide model 4; in_proj's columns (2 x 128 + 2 x state + 8) divide
    # it at state 8, not at state 5. Each route of in_proj's columns at
    # its (state, sequence) for 2 rows a rank: picked from a whole
    # in_proj; gathered as in_proj's columns (128 tokens a rank over d
    # 64); gathered as its output (32 tokens)
    "cfg_mamba": dict(name="t", family="ssm", n_layers=2, d_model=64,
                      n_heads=4, n_kv=4, d_ff=0, vocab=96, ssm_state=8,
                      ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
                      ssm_chunk=16, dtype="float32"),
    "mamba_routes": {"pick": (5, 32), "columns": (8, 64),
                     "output": (8, 16)},
    "mamba_decode_steps": 3,
    "opt": dict(lr=5e-3, warmup_steps=2, decay_steps=20),
    "data": dict(vocab=97, global_batch=8, seq_len=32),
    "data_tp": dict(vocab=96, global_batch=8, seq_len=32),
    "steps": 2, "loop_steps": 6, "decode_batch": 4, "decode_len": 64,
    # the hybrid's decode: its global layer's 16 slots and its windowed
    # layer's ring of 8 over model 4 (2 slots a block), 10 steps, so the
    # ring wraps from the last rank's block into the first's
    "hybrid_decode_len": 16, "hybrid_decode_steps": 10,
    # the encoder-decoder's decode on (data 4, model 2): the self caches'
    # 64 slots and the cross K / V's 16 frames split over model
    "encdec_decode_steps": 4,
}


def _inputs():
    """The reference's initial parameters (train and decode configs) and
    the other operands, as a flat numpy map."""
    x = {}
    for prefix, cfg, seed in (("init", SPEC["cfg"], 0),
                              ("decode", SPEC["cfg_decode"], 1),
                              ("moe_init", SPEC["cfg_moe"], 2),
                              ("vocab_init", SPEC["cfg_vocab"], 3),
                              ("hybrid_init", SPEC["cfg_hybrid"], 4),
                              ("encdec_init", SPEC["cfg_encdec"], 5),
                              ("moe_grouped_init", SPEC["cfg_moe_grouped"],
                               6)):
        params = jts.init_state(jax.random.PRNGKey(seed), JConfig(**cfg),
                                JAdamW())["params"]
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, leaf in flat:
            x[prefix + "/" + "/".join(str(p.key) for p in path)] = \
                np.asarray(leaf)
    rng = np.random.default_rng(0)
    x["decode_tokens"] = rng.integers(0, 97, size=(SPEC["decode_batch"], 3)
                                      ).astype(np.int32)
    x["hdecode_tokens"] = rng.integers(
        0, 96, size=(SPEC["decode_batch"], SPEC["hybrid_decode_steps"])
    ).astype(np.int32)
    enc = SPEC["cfg_encdec"]
    x["edecode_memory"] = (0.5 * rng.normal(size=(
        SPEC["decode_batch"], enc["encoder_seq"], enc["d_model"]))
    ).astype(np.float32)
    for i in range(4):
        x[f"pipe/w{i}"] = (rng.normal(size=(16, 16)) / 4).astype(np.float32)
        x[f"pipe/b{i}"] = rng.normal(size=(16,)).astype(np.float32)
    x["pipe/x"] = rng.normal(size=(6, 8, 16)).astype(np.float32)
    x["moe_tokens"] = rng.integers(0, 97, size=(4, 16)).astype(np.int32)
    enc = SPEC["cfg_encdec"]
    for i in range(SPEC["steps"]):
        x[f"encdec/frames{i}"] = (0.02 * rng.normal(size=(
            SPEC["data_tp"]["global_batch"], enc["encoder_seq"],
            enc["d_model"]))).astype(np.float32)
    x["prefill_tokens"] = rng.integers(0, 96, size=(8, 16)).astype(np.int32)
    d = SPEC["cfg_moe"]["d_model"]
    x["moe_ep/x"] = rng.normal(size=(4, 32, d)).astype(np.float32)
    x["moe_ep/c"] = rng.normal(size=(4, 32, d)).astype(np.float32)
    return x


REFERENCE = textwrap.dedent("""
    import json, os, sys, time
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.ckpt import checkpoint as ck
    from repro.data.pipeline import DataConfig, SyntheticDataset, make_batch
    from repro.distributed import sharding as sh
    from repro.distributed.pipeline_parallel import (pipeline_forward,
                                                     stack_stage_params)
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.train import train_loop
    from repro.models import model_zoo as zoo
    from repro.models.config import ModelConfig
    from repro.train import optimizer, train_state as ts
    from repro.train.optimizer import AdamWConfig

    d = sys.argv[1]
    spec = json.load(open(os.path.join(d, "spec.json")))

    def cfg_of(c):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in c.items()}
    x = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}

    def nested(prefix):
        tree = {}
        for k, v in x.items():
            if k.startswith(prefix + "/"):
                node = tree
                *path, leaf = k[len(prefix) + 1:].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(v)
        return tree

    def flat(tree):
        return {k: np.asarray(v) for k, v in ck._flatten(tree).items()}

    def wait_for(path):
        t0 = time.monotonic()
        while not os.path.exists(path):
            assert time.monotonic() - t0 < 600, path
            time.sleep(0.2)

    cfg, data = ModelConfig(**spec["cfg"]), DataConfig(**spec["data"])
    mesh = make_debug_mesh(data=2, model=4)
    init = nested("init")
    for tag, eight in (("f32", False), ("8bit", True)):
        opt = AdamWConfig(eight_bit=eight, **spec["opt"])
        state = {"params": init, "opt": optimizer.init(init, opt)}
        st_sh = sh.to_shardings(sh.state_specs(state, mesh), mesh)
        state = jax.tree.map(jax.device_put, state, st_sh)
        step = jax.jit(ts.make_train_step(cfg, opt, sh.make_shard_fn(mesh)),
                       in_shardings=(st_sh, None),
                       out_shardings=(st_sh, None))
        for i in range(spec["steps"]):
            with mesh:
                state, m = step(state, make_batch(cfg, data, i))
            for k in ("loss", "grad_norm", "lr"):
                out[f"{tag}/{k}{i}"] = np.asarray(m[k])
        for k, v in flat(state).items():
            out[f"{tag}/state/{k}"] = v
        if tag == "f32":
            ck.save(os.path.join(d, "ref_ckpt"), spec["steps"], state)
            open(os.path.join(d, "ref_ckpt", "done"), "w").close()
            like, f32_sh = state, st_sh

    # a moe model's steps: experts over "model" in E, the flat dispatch
    # over the global batch (capacity factor 1.25: tokens are dropped)
    mcfg, opt = ModelConfig(**spec["cfg_moe"]), AdamWConfig(**spec["opt"])
    minit = nested("moe_init")
    state = {"params": minit, "opt": optimizer.init(minit, opt)}
    st_sh = sh.to_shardings(sh.state_specs(state, mesh), mesh)
    state = jax.tree.map(jax.device_put, state, st_sh)
    step = jax.jit(ts.make_train_step(mcfg, opt, sh.make_shard_fn(mesh)),
                   in_shardings=(st_sh, None), out_shardings=(st_sh, None))
    for i in range(spec["steps"]):
        with mesh:
            state, m = step(state, make_batch(mcfg, data, i))
        for k in ("loss", "grad_norm", "lr"):
            out[f"moe/{k}{i}"] = np.asarray(m[k])
    for k, v in flat(state).items():
        out[f"moe/state/{k}"] = v
    gcfg = ModelConfig(**spec["cfg_moe_grouped"])
    ginit = nested("moe_grouped_init")
    state = {"params": ginit, "opt": optimizer.init(ginit, opt)}
    st_sh = sh.to_shardings(sh.state_specs(state, mesh), mesh)
    state = jax.tree.map(jax.device_put, state, st_sh)
    step = jax.jit(ts.make_train_step(gcfg, opt, sh.make_shard_fn(mesh)),
                   in_shardings=(st_sh, None), out_shardings=(st_sh, None))
    for i in range(spec["steps"]):
        with mesh:
            state, m = step(state, make_batch(gcfg, data, i))
        for k in ("loss", "grad_norm", "lr"):
            out[f"grouped/{k}{i}"] = np.asarray(m[k])
    for k, v in flat(state).items():
        out[f"grouped/state/{k}"] = v

    ds = SyntheticDataset(data)
    bspec = sh.batch_specs({"tokens": jax.ShapeDtypeStruct(
        (data.global_batch, data.seq_len), jnp.int32)}, mesh)["tokens"]
    arr = ds.global_batch(3, NamedSharding(mesh, bspec))
    out["gb/full"] = np.asarray(arr)
    for shard in arr.addressable_shards:
        i, j = np.argwhere(mesh.devices == shard.device)[0]
        out[f"gb/{i}_{j}"] = np.asarray(shard.data)

    dcfg = ModelConfig(**spec["cfg_decode"])
    params = nested("decode")
    b, s = spec["decode_batch"], spec["decode_len"]
    p_sh = sh.to_shardings(sh.params_specs(params, mesh), mesh)
    caches = zoo.init_caches(params, dcfg, b, s, dtype=jnp.float32)
    c_sh = sh.to_shardings(sh.cache_specs(caches, mesh), mesh)
    params_s = jax.tree.map(jax.device_put, params, p_sh)
    caches_s = jax.tree.map(jax.device_put, caches, c_sh)
    f = jax.jit(lambda p, t, c, i: zoo.decode_step(p, t, dcfg, c, i),
                in_shardings=(p_sh, None, c_sh, None),
                out_shardings=(None, c_sh))
    toks = jnp.asarray(x["decode_tokens"])
    for i in range(toks.shape[1]):
        with mesh:
            logits, caches_s = f(params_s, toks[:, i:i + 1], caches_s,
                                 jnp.int32(i))
        out[f"decode/logits{i}"] = np.asarray(logits)

    # TP cases: train steps of three models, and the vocab-split model's
    # prefill and decode
    tdata = DataConfig(**spec["data_tp"])
    for tag in ("vocab", "hybrid", "encdec"):
        tcfg = ModelConfig(**cfg_of(spec[f"cfg_{tag}"]))
        opt = AdamWConfig(**spec["opt"])
        tinit = nested(f"{tag}_init")
        state = {"params": tinit, "opt": optimizer.init(tinit, opt)}
        st_sh = sh.to_shardings(sh.state_specs(state, mesh), mesh)
        state = jax.tree.map(jax.device_put, state, st_sh)
        step = jax.jit(ts.make_train_step(tcfg, opt, sh.make_shard_fn(mesh)),
                       in_shardings=(st_sh, None),
                       out_shardings=(st_sh, None))
        for i in range(spec["steps"]):
            batch = make_batch(tcfg, tdata, i)
            if tcfg.family == "encdec":
                batch["frames"] = jnp.asarray(x[f"encdec/frames{i}"])
            with mesh:
                state, m = step(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                out[f"{tag}/{k}{i}"] = np.asarray(m[k])
        for k, v in flat(state).items():
            out[f"{tag}/state/{k}"] = v
    vcfg = ModelConfig(**cfg_of(spec["cfg_vocab"]))
    params = nested("vocab_init")
    p_sh = sh.to_shardings(sh.params_specs(params, mesh), mesh)
    params_s = jax.tree.map(jax.device_put, params, p_sh)
    pf = jax.jit(lambda p, t: zoo.prefill(p, {"tokens": t}, vcfg),
                 in_shardings=(p_sh, None))
    with mesh:
        logits, _, kv = pf(params_s, jnp.asarray(x["prefill_tokens"]))
    out["prefill/logits"] = np.asarray(logits)
    for k in ("k", "v"):
        out[f"prefill/{k}"] = np.asarray(kv[k])
    caches = zoo.init_caches(params, vcfg, b, s, dtype=jnp.float32)
    c_sh = sh.to_shardings(sh.cache_specs(caches, mesh), mesh)
    caches_s = jax.tree.map(jax.device_put, caches, c_sh)
    f = jax.jit(lambda p, t, c, i: zoo.decode_step(p, t, vcfg, c, i),
                in_shardings=(p_sh, None, c_sh, None),
                out_shardings=(None, c_sh))
    for i in range(toks.shape[1]):
        with mesh:
            logits, caches_s = f(params_s, toks[:, i:i + 1], caches_s,
                                 jnp.int32(i))
        out[f"vdecode/logits{i}"] = np.asarray(logits)

    # decode at cache_specs: the hybrid (its ring wrapping across the
    # blocks), the moe, the dense model with seq_shard off and the
    # encoder-decoder on (data 4, model 2), its cross K / V split
    def decode(tag, dcfg, params, toks, s, dmesh, seq_shard=True,
               memory=None):
        p_sh = sh.to_shardings(sh.params_specs(params, dmesh), dmesh)
        caches = zoo.init_caches(params, dcfg, toks.shape[0], s,
                                 memory=memory, dtype=jnp.float32)
        c_sh = sh.to_shardings(sh.cache_specs(caches, dmesh, seq_shard),
                               dmesh)
        params_s = jax.tree.map(jax.device_put, params, p_sh)
        caches_s = jax.tree.map(jax.device_put, caches, c_sh)
        f = jax.jit(lambda p, t, c, i: zoo.decode_step(p, t, dcfg, c, i),
                    in_shardings=(p_sh, None, c_sh, None),
                    out_shardings=(None, c_sh))
        for i in range(toks.shape[1]):
            with dmesh:
                logits, caches_s = f(params_s, toks[:, i:i + 1], caches_s,
                                     jnp.int32(i))
            out[f"{tag}/logits{i}"] = np.asarray(logits)

    htoks = jnp.asarray(x["hdecode_tokens"])
    decode("hdecode", ModelConfig(**cfg_of(spec["cfg_hybrid"])),
           nested("hybrid_init"), htoks, spec["hybrid_decode_len"], mesh)
    decode("mdecode", ModelConfig(**spec["cfg_moe"]), nested("moe_init"),
           toks, s, mesh)
    decode("wdecode", dcfg, nested("decode"), toks, s, mesh,
           seq_shard=False)
    decode("odecode", dcfg, nested("decode"), toks[:3], s, mesh)
    decode("edecode", ModelConfig(**cfg_of(spec["cfg_encdec"])),
           nested("encdec_init"),
           htoks[:, :spec["encdec_decode_steps"]], s,
           make_debug_mesh(data=4, model=2),
           memory=jnp.asarray(x["edecode_memory"]))

    pmesh = jax.make_mesh((4,), ("stage",))
    per_stage = [{"w": jnp.asarray(x[f"pipe/w{i}"]),
                  "b": jnp.asarray(x[f"pipe/b{i}"])} for i in range(4)]
    run = pipeline_forward(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), pmesh)
    with pmesh:
        out["pipe/y"] = np.asarray(jax.jit(run)(
            stack_stage_params(per_stage), jnp.asarray(x["pipe/x"])))

    # the port's checkpoint, written on its 2 x 4 mesh, read back here
    port = os.path.join(d, "port_ckpt_jax")
    wait_for(os.path.join(port, f"step_{spec['steps']:010d}",
                          "manifest.json"))
    got, _ = ck.restore(port, like, shardings=f32_sh)
    for k, v in flat(got).items():
        out[f"xport/{k}"] = v

    _, hist = train_loop(cfg, AdamWConfig(**spec["opt"]), data, mesh,
                         spec["loop_steps"], os.path.join(d, "ref_loop"),
                         save_interval=2, log_every=100)
    open(os.path.join(d, "ref_loop", "done"), "w").close()
    out["loop/history"] = np.asarray(hist)
    np.savez(os.path.join(d, "reference.npz"), **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shard"))
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(SPEC, f)
    x = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    port_env = dict(env, OMP_NUM_THREADS="1")
    worker = os.path.join(ROOT, "tests", "test_torch_shard_worker.py")
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, d],
                              env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), d],
                               env=port_env, cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in range(WORLD)]
    failed = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            if p.returncode != 0:
                failed.append(f"{p.args[:2]} rc={p.returncode}\n"
                              f"{out[-3000:]}\n{err[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failed, "\n\n".join(failed)
    return {"inputs": x,
            "ref": dict(np.load(os.path.join(d, "reference.npz"))),
            "port": [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                     for r in range(WORLD)],
            "meta": [json.load(open(os.path.join(d, f"rank{r}.json")))
                     for r in range(WORLD)]}


def _state(out, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix)}


def _whole_blocks(key, flat):
    """Does every layer of ``key``'s parameter hold whole 256-value blocks
    (so the port's per-layer codes stack into the reference's)?"""
    param = "params/" + key.split("/", 2)[2].rsplit("/", 1)[0]
    return int(np.prod(flat[param].shape)) % Q_BLOCK == 0


@pytest.mark.parametrize("tag", ["f32", "8bit"])
def test_sharded_train_step(runs, tag):
    """Two steps on 2 x 4 against the port's one-device steps and the
    reference's sharded ones: losses, grad norms, lr, the parameters
    (gathered) and, with 8-bit moments, the codes; every rank's gathered
    state bitwise the same."""
    port, ref = runs["port"][0], runs["ref"]
    for i in range(SPEC["steps"]):
        for k, tol in (("loss", LOSS_RTOL), ("grad_norm", LOSS_RTOL),
                       ("lr", LR_RTOL)):
            got = port[f"{tag}/{k}{i}"]
            np.testing.assert_allclose(got, port[f"{tag}/one/{k}{i}"],
                                       rtol=tol, err_msg=f"{k}{i}")
            np.testing.assert_allclose(got, ref[f"{tag}/{k}{i}"], rtol=tol,
                                       err_msg=f"{k}{i} vs reference")
    mine = _state(port, f"{tag}/state/")
    one = _state(port, f"{tag}/one/state/")
    theirs = _state(ref, f"{tag}/state/")
    stacked = convert.train_state_to_jax(
        {k: v for k, v in mine.items()
         if not k.endswith((".q", ".scale"))})
    for k, v in mine.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(v, one[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    for k, v in stacked.items():
        if k.startswith("params/"):
            # where the 8-bit blocks straddle layers the moments code
            # other values: a code apart moves a step by up to ~2 lr
            layer = v.shape[1:] if convert._is_stacked(k) else v.shape
            whole = tag == "f32" or int(np.prod(layer)) % Q_BLOCK == 0
            atol = PARAM_ATOL if whole else EIGHT_BIT_ATOL
            np.testing.assert_allclose(v, theirs[k], atol=atol, rtol=0,
                                       err_msg=k)
    if tag == "8bit":
        codes = [k for k in mine if k.endswith("/.q")]
        compared = [k for k in codes if _whole_blocks(k, mine)]
        assert compared and len(compared) < len(codes)
        whole = convert.train_state_to_jax(
            {k: v for k, v in mine.items() if k in compared
             or k.startswith("params/")
             or (k.endswith("/.scale") and k[:-len(".scale")] + ".q"
                 in compared)})
        off = n = worst = 0
        for k, v in whole.items():
            if k.endswith("/.q"):
                delta = np.abs(v.astype(int) - theirs[k].astype(int))
                off, n = off + int((delta > 0).sum()), n + delta.size
                worst = max(worst, int(delta.max()))
        assert off / n <= CODES_OFF_SHARE and worst <= 1, (off, n, worst)
    for r in range(1, WORLD):
        for k, v in _state(runs["port"][r], f"{tag}/state/").items():
            assert np.array_equal(v, mine[k]), (r, k)


@pytest.mark.parametrize("tag", ["f32", "8bit"])
def test_state_bytes_placements_and_counters(runs, tag):
    """Each rank's local state bytes equal the specs' shard bytes, every
    leaf sits at state_specs' placements before and after the steps, and
    each step counts ZeRO's DP traffic and the gathers over "model"."""
    for meta in runs["meta"]:
        local, want = meta[f"{tag}/bytes"]
        assert local == want
        assert meta[f"{tag}/placed"] and meta[f"{tag}/placed_after"]
        for i in range(SPEC["steps"]):
            c = meta[f"{tag}/counters{i}"]
            assert c["collective.bytes"] > 0
            assert c["shard.redistribute_bytes"] > 0


def test_global_batch_shards_are_the_references(runs):
    """Each rank's tokens are the reference's shard on the device at the
    same mesh coordinate, bitwise; with accum 2 its block of the
    microbatches is the reference's global batch's."""
    full = runs["ref"]["gb/full"]
    b = SPEC["data"]["global_batch"]
    for out, meta in zip(runs["port"], runs["meta"]):
        i, j = meta["coord24"]
        assert np.array_equal(out["gb/tokens"], runs["ref"][f"gb/{i}_{j}"])
        idx = tuple(slice(*s) for s in meta["gb/index"])
        assert np.array_equal(out["gb/tokens"], full[idx])
        idx = tuple(slice(*s) for s in meta["gb/accum2_index"])
        assert np.array_equal(out["gb/accum2"],
                              full.reshape(2, b // 2, -1)[idx])


DECODE_OPS = ["decode combine", "decode kv token", "decode q"]


def _decode_op_bytes(rows, hq, hd, n_kv, model, layers, heads_split,
                     cross=False):
    """The bytes each decode op brings a rank over "model" a step, f32: q
    of its heads' columns gathered (every head's q where TP split the
    heads, else wq's output columns), the token's k and v columns, and
    the combine's three all-reduces (m, l: rows x Hq; o: rows x Hq x
    hd), a layer; cross-attention gathers q and combines again."""
    n = model - 1
    q = n * rows * hq * hd // model * 4
    kv = 2 * n * rows * n_kv * hd // model * 4
    combine = sum(2 * n * e * 4 // model
                  for e in (rows * hq, rows * hq, rows * hq * hd))
    passes = 2 if cross else 1
    return {"decode q": layers * passes * q, "decode kv token": layers * kv,
            "decode combine": layers * passes * combine}


def _decode_agrees(runs, tag, steps, want_ops=None, state=0):
    """``tag``'s decode on every rank: each step's logits within 2e-3 of
    the port's one-device decode and of the reference's sharded decode;
    the caches gathered within 1e-6 of one device's; each rank's cache
    leaves their spec's blocks; each step's decode ops those named, with
    ``want_ops``' bytes where given; no k or v gathered (``decode
    caches``, the whole-cache route's gather, at 0 bytes, and no
    attention projection's output redistributed) and ``decode ssm
    state`` at ``state``."""
    for out, meta in zip(runs["port"], runs["meta"]):
        facts = meta[tag]
        for i in range(steps):
            got = out[f"{tag}/logits{i}"]
            np.testing.assert_allclose(got, out[f"{tag}/one/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            np.testing.assert_allclose(got, runs["ref"][f"{tag}/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            assert sorted(facts["ops"][i]) == DECODE_OPS
            if want_ops is not None:
                assert facts["ops"][i] == want_ops, (facts["ops"][i],
                                                     want_ops)
            assert facts["counters"][i]["shard.decode_bytes"] == \
                sum(facts["ops"][i].values())
            assert facts["decode_caches"][i] == 0
            assert not any(op.startswith("attention")
                           for op in facts["redistributed"][i])
            assert facts["decode_state"][i] == state
        assert facts["local"] == facts["block"]
    port = runs["port"][0]
    keys = [k for k in port if k.startswith(f"{tag}/cache/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k], port[k.replace(
            f"{tag}/", f"{tag}/one/", 1)], atol=1e-6, err_msg=k)


def test_sharded_decode(runs):
    """Three decode steps with parameters at params_specs and f32 caches
    at cache_specs: the logits within the reference test's 2e-3 of the
    port's one-device decode and of the reference's sharded decode, on
    every rank; the caches written as one device writes them; each rank
    holding a quarter of the sequence and half of the batch. The three
    steps' keys lie in the first rank's block of 16 (the others are
    wholly masked). No cache leaf is gathered: the counted ops are the
    new ones, q (the rank's one head of 4) and the token's k and v (its
    16 columns of each) gathered over "model" and the combine, exactly,
    and nothing is redistributed."""
    b, s = SPEC["decode_batch"], SPEC["decode_len"]
    cfg = SPEC["cfg_decode"]
    want = _decode_op_bytes(b // 2, cfg["n_heads"], 16, cfg["n_kv"], 4,
                            cfg["n_layers"], True)
    _decode_agrees(runs, "decode", 3, want)
    for meta in runs["meta"]:
        assert list(meta["decode"]["local"].values()) == \
            [[2, b // 2, s // 4, 4, 16]] * 2
        for c in meta["decode"]["counters"]:
            assert "shard.redistribute_bytes" not in c
            assert c["collective.bytes"] > c["shard.decode_bytes"] > 0
    one = runs["port"][0]["decode/one/cache/k"]
    assert np.abs(one[:, :, 3:]).max() == 0 < np.abs(one[:, :, :3]).max()


def test_decode_on_sequence_blocks(runs):
    """The hybrid on 2 x 4 over 10 steps: its global layer's 16 slots and
    its windowed layer's ring of 8 (2 a rank) split over "model", the
    ring wrapping from the last rank's block into the first's; its 5
    heads do not divide model 4, so q of every head is wq's output
    gathered and the core runs every head over the rank's block; its 8
    SSM heads do, so each rank keeps its 2-head block of the state and
    updates it in place (``decode ssm state`` at 0 bytes), and only
    in_proj's output (one token's) and the logits are redistributed.
    Against the reference's sharded decode and one device's, every
    step."""
    cfg = SPEC["cfg_hybrid"]
    steps, b = SPEC["hybrid_decode_steps"], SPEC["decode_batch"]
    assert steps > cfg["window"]
    rows, model = b // 2, 4
    heads = 2 * cfg["d_model"] // cfg["ssm_head_dim"]
    want = _decode_op_bytes(rows, cfg["n_heads"], cfg["head_dim"],
                            cfg["n_kv"], model, cfg["n_layers"], False)
    _decode_agrees(runs, "hdecode", steps, want, state=0)
    for meta in runs["meta"]:
        local = meta["hdecode"]["local"]
        assert local["0/attn/k"] == [rows, 16 // model, 1, 16]
        assert local["1/attn/k"] == [rows, 8 // model, 1, 16]
        for i in range(cfg["n_layers"]):
            assert local[f"{i}/ssm/state"] == [
                rows, heads // model, cfg["ssm_head_dim"], cfg["ssm_state"]]
        assert all(r == ["decode logits", "mamba in_proj output"]
                   for r in meta["hdecode"]["redistributed"])


def test_encdec_decode_on_split_cross_caches(runs):
    """The encoder-decoder on (data 4, model 2): its self caches' 64 slots
    and its cross K / V's 16 frames split over "model" (8 a rank), q
    gathered for both attentions; against the reference's sharded
    decode and one device's, every step."""
    cfg = SPEC["cfg_encdec"]
    b, s = SPEC["decode_batch"], SPEC["decode_len"]
    want = _decode_op_bytes(b // 4, cfg["n_heads"], 16, cfg["n_kv"], 2,
                            cfg["n_layers"], True, cross=True)
    _decode_agrees(runs, "edecode", SPEC["encdec_decode_steps"], want)
    for meta in runs["meta"]:
        local = meta["edecode"]["local"]
        assert local["cross_k"] == [2, 1, cfg["encoder_seq"] // 2, 4, 16]
        assert local["self/k"] == [2, 1, s // 2, 4, 16]


def _mamba_bytes(route):
    """What one forward and backward of the Mamba-2 case's block moves on
    2 x 4 in ``route`` (SPEC's ``mamba_routes``): the redistributed bytes
    by op (in_proj's columns or its output gathered, (n - 1) blocks of
    the rank's, and reduce-scattered back, as much again; none where
    in_proj is whole) and TP's all-reduces, 2 (n - 1) / n of each
    all-reduced tensor: the norm's sum of squares (forward, and its
    gradient), out_proj's partial output, the input's gradient, and the
    gradients of the leaves picked whole (conv_w, conv_b, a_log, dt_bias,
    d_skip, the norm's scale, and in_proj where it is whole)."""
    cfg = SPEC["cfg_mamba"]
    state, seq = SPEC["mamba_routes"][route]
    n, d = 4, cfg["d_model"]
    di = cfg["ssm_expand"] * d
    h = di // cfg["ssm_head_dim"]
    width, conv = 2 * di + 2 * state + h, di + 2 * state
    tokens = SPEC["decode_batch"] // 2 * seq
    moved = {"pick": {},
             "columns": {"mamba in_proj columns": 2 * (n - 1) * d * width
                         // n * 4},
             "output": {"mamba in_proj output": 2 * (n - 1) * tokens
                        * width // n * 4}}[route]
    reduced = 2 * tokens + 2 * tokens * d + (4 + 1) * conv + 3 * h + di \
        + (d * width if route == "pick" else 0)
    return moved, 2 * (n - 1) * reduced * 4 // n


@pytest.mark.parametrize("route", ["pick", "columns", "output"])
def test_mamba_by_head(runs, route):
    """The port's Mamba-2 block by head on 2 x 4 (8 heads, 2 a rank): one
    forward and backward of each rank's rows against one device's, the
    output and every gradient (the input's and each leaf's, gathered)
    within 1e-5 of its largest value; in_proj's columns picked from a
    whole leaf (state 5: 274 columns do not divide model 4), gathered as
    in_proj's columns (more tokens a rank than d_model) or as its output
    (fewer), chosen from the shapes alone; each route's bytes exactly
    :func:`_mamba_bytes`'."""
    moved, reduced = _mamba_bytes(route)
    cfg = SPEC["cfg_mamba"]
    state = SPEC["mamba_routes"][route][0]
    width = 4 * cfg["d_model"] + 2 * state + 8
    for meta in runs["meta"]:
        got = meta["mamba"][route]
        # in_proj's columns split over "model" where they divide it (its
        # rows over "data"), else over "data" only: whole over "model"
        assert got["in_proj_local"] == ([cfg["d_model"], width // 2]
                                        if route == "pick" else
                                        [cfg["d_model"] // 2, width // 4])
        assert got["redistributed"] == moved, got
        assert got["tp_all_reduce_bytes"] == reduced, got
        for k, e in got["err"].items():
            assert e <= LOSS_RTOL, (route, k, e)


def test_mamba_decode_on_head_blocks(runs):
    """Three decode steps of the ssm model whose in_proj is whole (its 8
    heads divide model 4, its 274 columns do not), the port alone: the
    logits within 2e-3 of one device's, the caches gathered within 1e-6;
    each layer's state held as the rank's 2-head block of its stacked
    leaf and updated in place, the conv tail whole; nothing
    redistributed but the logits."""
    cfg = SPEC["cfg_mamba"]
    state = SPEC["mamba_routes"]["pick"][0]
    rows = SPEC["decode_batch"] // 2
    for out, meta in zip(runs["port"], runs["meta"]):
        facts = meta["sdecode"]
        for i in range(SPEC["mamba_decode_steps"]):
            np.testing.assert_allclose(out[f"sdecode/logits{i}"],
                                       out[f"sdecode/one/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            assert facts["redistributed"][i] == ["decode logits"]
            assert facts["decode_state"][i] == facts["decode_caches"][i] \
                == 0
        assert facts["local"] == facts["block"]
        assert facts["local"]["state"] == [
            cfg["n_layers"], rows, 2, cfg["ssm_head_dim"], state]
        for k in ("state", "conv"):
            np.testing.assert_allclose(out[f"sdecode/cache/{k}"],
                                       out[f"sdecode/one/cache/{k}"],
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("tag", ["mdecode", "vdecode"])
def test_moe_and_vocab_decode_on_sequence_blocks(runs, tag):
    """The moe (experts over "model") and the vocab-split model decode on
    the caches' blocks too: three steps against the reference's sharded
    decode and one device's."""
    _decode_agrees(runs, tag, 3)


def test_decode_with_rows_whole(runs):
    """3 rows do not divide "data" 2: the caches' batch stays whole and
    every rank decodes every row, on its block of the sequence still;
    against the reference's sharded decode and one device's."""
    s = SPEC["decode_len"]
    _decode_agrees(runs, "odecode", 3)
    for meta in runs["meta"]:
        assert list(meta["odecode"]["local"].values()) == \
            [[2, 3, s // 4, 4, 16]] * 2


def test_seq_shard_off_keeps_the_whole_cache_route(runs):
    """``seq_shard=False``: the caches whole over "model" (batch over
    "data" only), decode as before: the token's k and v columns gathered
    as redistributions, no decode op; the logits within 2e-3 of the
    reference's decode at the same specs and of one device's."""
    b, s = SPEC["decode_batch"], SPEC["decode_len"]
    for out, meta in zip(runs["port"], runs["meta"]):
        facts = meta["wdecode"]
        for i in range(3):
            got = out[f"wdecode/logits{i}"]
            np.testing.assert_allclose(got, out[f"wdecode/one/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            np.testing.assert_allclose(got,
                                       runs["ref"][f"wdecode/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            assert facts["ops"][i] == {}
            assert "shard.decode_bytes" not in facts["counters"][i]
            assert facts["redistributed"][i] == ["attention wk output",
                                                 "attention wv output"]
        assert list(facts["local"].values()) == [[2, b // 2, s, 4, 16]] * 2


def test_moe_forward_on_expert_sharded_leaves(runs):
    """A moe model's experts sharded over "model" in E (2 of 8 a rank),
    capacity factor 1.25 as registered: each rank's rows of the forward
    and the aux loss within 1e-5 of the one-device forward's (each rank
    runs its 2 experts on its window of their slots, the outputs summed
    over "model"; capacity, drops and aux come from the global batch)."""
    for out, meta in zip(runs["port"], runs["meta"]):
        assert meta["moe/experts_local"] == [2, 32, 48]
        np.testing.assert_allclose(out["moe/logits"], out["moe/one/logits"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["moe/aux"], out["moe/one/aux"],
                                   atol=1e-5, rtol=0)


def test_moe_serving_on_expert_sharded_leaves(runs):
    """The moe model's prefill (each rank its rows) and three decode steps
    of 4 rows on 2 x 4 (2 rows a data rank: 8 slots an expert, each rank
    multiplying 4 of them on its 2 experts) within the decode tolerance
    of one device's, every rank; each decode step exchanges the slots."""
    cfg, data, model = _moe_layer_cfg()
    e, dm = cfg["n_experts"], cfg["d_model"]
    for out, meta in zip(runs["port"], runs["meta"]):
        np.testing.assert_allclose(out["moe/prefill"], out["moe/one/prefill"],
                                   atol=DECODE_ATOL, rtol=0)
        for i in range(3):
            np.testing.assert_allclose(out[f"mdecode/logits{i}"],
                                       out[f"mdecode/one/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
        window = (data - 1) * e // model * 8 // data * dm * 4
        assert sum(c["shard.expert_exchange_bytes"]
                   for c in meta["mdecode"]["counters"]) \
            == 3 * cfg["n_layers"] * 2 * window


def _moe_steps_agree(runs, tag):
    """Two moe steps on 2 x 4 against the port's one-device steps and the
    reference's sharded ones: losses, grad norms, lr and the parameters;
    every rank's gathered state the same."""
    port, ref = runs["port"][0], runs["ref"]
    for i in range(SPEC["steps"]):
        for k, tol in (("loss", LOSS_RTOL), ("grad_norm", LOSS_RTOL),
                       ("lr", LR_RTOL)):
            got = port[f"{tag}/{k}{i}"]
            np.testing.assert_allclose(got, port[f"{tag}/one/{k}{i}"],
                                       rtol=tol, err_msg=f"{k}{i}")
            np.testing.assert_allclose(got, ref[f"{tag}/{k}{i}"], rtol=tol,
                                       err_msg=f"{k}{i} vs reference")
    mine = _state(port, f"{tag}/state/")
    one = _state(port, f"{tag}/one/state/")
    for k, v in mine.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(v, one[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    theirs = _state(ref, f"{tag}/state/")
    for k, v in convert.train_state_to_jax(mine).items():
        if k.startswith("params/"):
            np.testing.assert_allclose(v, theirs[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    for r in range(1, WORLD):
        for k, v in _state(runs["port"][r], f"{tag}/state/").items():
            assert np.array_equal(v, mine[k]), (r, k)


def test_sharded_moe_train_step(runs):
    """Two moe steps on 2 x 4 with the experts over "model" and the
    registered capacity factor 1.25, tokens dropped at the first step:
    losses, grad norms, lr and the parameters against the port's
    one-device steps and the reference's sharded ones (each rank's flat
    dispatch sees the global batch: capacity, drops and the aux loss)."""
    assert sum(runs["meta"][0]["moe/dropped_step0"]) > 0
    _moe_steps_agree(runs, "moe")


def test_grouped_moe_train_step(runs):
    """``moe_grouped`` (each batch row its own group, 8 slots an expert)
    on 2 x 4: the experts split over "model", no exchange over the DP
    ranks (a rank's groups are its own rows); two steps against one
    device's and the reference's sharded ones."""
    _moe_steps_agree(runs, "grouped")
    for meta in runs["meta"]:
        for i in range(SPEC["steps"]):
            c = meta[f"grouped/counters{i}"]
            assert "shard.expert_exchange_bytes" not in c
            assert c["shard.tp_all_reduce_bytes"] > 0


def _moe_layer_cfg():
    return SPEC["cfg_moe"], 2, 4               # cfg, data, model


def test_moe_exchanged_windows_are_the_one_device_buffer(runs):
    """The moe FFN alone on (data 2, model 4), 4 x 32 tokens (40 slots an
    expert): each rank's (2, 20, 64) window of its experts' slots, after
    the exchange over "data", is the one-device (8, 40, 64) buffer's
    block, bitwise (w_in's and w_gate's operand); its output and aux
    within 1e-5 of one device's."""
    cfg, data, model = _moe_layer_cfg()
    e, dm = cfg["n_experts"], cfg["d_model"]
    for out, meta in zip(runs["port"], runs["meta"]):
        ep = meta["moe_ep"]
        assert ep["windows"] == [[e // model, 40 // data, dm]] * 2
        assert ep["whole"] == [[e, 40, dm]] * 2
        assert ep["bitwise"] and ep["slots_filled"] > 0
        np.testing.assert_allclose(out["moe_ep/y"], out["moe_ep/one/y"],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["moe_ep/aux"], out["moe_ep/one/aux"],
                                   atol=1e-5, rtol=0)


def test_moe_router_gradient_at_model_4(runs):
    """The router's gradient (whole on every rank, its block kept) and the
    experts' (each rank's block) against one device's within PARAM_ATOL:
    the gates' gradients, each model rank's from its experts only, are
    summed over "model" before they reach the router."""
    for meta in runs["meta"]:
        errs = meta["moe_ep"]["grad_err"]
        assert sorted(errs) == ["router", "w_gate", "w_in", "w_out"]
        for k, err in errs.items():
            assert err <= PARAM_ATOL, (k, err)


def test_moe_step_exchange_and_redistribution(runs):
    """A moe step's exchange over "data": (data - 1) x E' x cap / data x d
    x 4 bytes each way, forward, in remat's recompute and backward (6 a
    layer, an obs event each), counted under
    ``shard.expert_exchange_bytes`` to the byte; of the blocks'
    parameters only the router is gathered over "model", forward and
    recompute (the kv columns are attention's: n_kv 2 on model 4)."""
    cfg, data, model = _moe_layer_cfg()
    tokens = SPEC["data"]["global_batch"] * SPEC["data"]["seq_len"]
    cap = -(-int(tokens * cfg["top_k"] / cfg["n_experts"]
                 * cfg["capacity_factor"]) // 8) * 8
    window = cfg["n_experts"] // model * cap // data * cfg["d_model"] * 4
    router = cfg["d_model"] // data * cfg["n_experts"] // model * 4
    for meta in runs["meta"]:
        for i in range(SPEC["steps"]):
            c = meta[f"moe/counters{i}"]
            assert c["shard.expert_exchange_bytes"] == \
                6 * cfg["n_layers"] * (data - 1) * window
            assert meta[f"moe/exchanges{i}"] == 6 * cfg["n_layers"]
            moved = meta[f"moe/redistributed{i}"]
            assert sorted(moved) == ["attention wk columns",
                                     "attention wv columns",
                                     "blocks/0 parameters",
                                     "blocks/1 parameters"]
            for layer in range(cfg["n_layers"]):
                assert moved[f"blocks/{layer} parameters"] == \
                    2 * (model - 1) * router


@pytest.mark.parametrize("tag", ["f32", "moe"])
def test_backward_events_reach_the_forwards_trace(runs, tag):
    """A sharded step's backward on a fresh thread emits its obs events
    into the forward's trace: its ``shard.redistribute`` events (the
    kv heads' columns summed back, n_kv 2 on model 4) and the moe's
    ``shard.expert_exchange`` events carry the bytes its counters moved,
    as on the calling thread; over the whole step too."""
    for meta in runs["meta"]:
        for fresh in ("false", "true"):
            events = meta[f"thread/{tag}"][fresh]["events"]
            for name, e in events.items():
                assert e["bwd_events"] == e["bwd_counter"], (name, e)
                assert e["events"] == e["counter"], (name, e)
            assert events["shard.redistribute"]["bwd_events"] > 0
            if tag == "moe":
                assert events["shard.expert_exchange"]["bwd_events"] > 0


@pytest.mark.parametrize("tag", ["f32", "moe"])
def test_backward_on_a_fresh_thread(runs, tag):
    """A sharded step's backward run on a fresh thread (no ContextVars, as
    autograd's device thread on the card) records, in the transport scope
    of its forward, what it records on the calling thread: remat's
    recompute gathers over "data", every collective of the backward (the
    moe's slot exchange too); the "model" all-reduces equal
    ``shard.tp_all_reduce_bytes``."""
    n_model = 4
    for meta in runs["meta"]:
        same, fresh = (meta[f"thread/{tag}"][k] for k in ("false", "true"))
        assert fresh["fwd"] == same["fwd"]
        assert fresh["bwd"] == same["bwd"]
        bwd = fresh["bwd"]
        assert any(k == "all_gather" and a == "data" for k, a, _ in bwd)
        assert any(k == "reduce_scatter" and a == "data" for k, a, _ in bwd)
        reduces = [b for k, a, b in fresh["fwd"] + bwd
                   if k == "all_reduce" and a == "model"]
        assert any(k == "all_reduce" and a == "model" for k, a, _ in bwd)
        assert sum(2 * (n_model - 1) * b // n_model for b in reduces) == \
            fresh["counters"]["shard.tp_all_reduce_bytes"]


def test_pipeline_forward(runs):
    """Four stages over six microbatches: bitwise the stages run in order
    on one rank, within the reference test's 1e-4 of its pipeline, the
    same on every rank of both data rows."""
    port = runs["port"][0]
    assert np.array_equal(port["pipe/y"], port["pipe/seq"])
    np.testing.assert_allclose(port["pipe/y"], runs["ref"]["pipe/y"],
                               atol=PIPE_ATOL)
    for out in runs["port"][1:]:
        assert np.array_equal(out["pipe/y"], port["pipe/y"])


def test_elastic_restore(runs):
    """A one-device checkpoint restored onto 4 x 2 (read block by block),
    re-placed in memory onto 2 x 4, and restored onto one device: every
    leaf bitwise the saved one, at the new mesh's specs."""
    for meta in runs["meta"]:
        assert meta["elastic/step"] == 3
        for k in ("placed42", "bitwise42", "placed24", "bitwise24",
                  "bitwise1"):
            assert meta[f"elastic/{k}"], k


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_cross_packages(runs, direction):
    """A train state saved on the port's 2 x 4 mesh restores in the
    reference on its 2 x 4 mesh (through ``train_state_to_jax``), and the
    reference's sharded save restores on the port's mesh (through
    ``train_state_from_jax``), each bitwise what the other saved."""
    port, ref = runs["port"][0], runs["ref"]
    if direction == "port_to_reference":
        saved = convert.train_state_to_jax(_state(port, "f32/state/"))
        got = _state(ref, "xport/")
    else:
        saved = convert.train_state_from_jax(_state(ref, "f32/state/"))
        got = _state(port, "xref/")
        assert all(m["xref/placed"] for m in runs["meta"])
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert np.array_equal(got[k], v), k


def test_train_loop_on_a_mesh_with_a_restart(runs):
    """``train_loop(mesh=2 x 4)`` resumed from the reference loop's step-2
    checkpoint: its losses at steps 3-5 within 1e-5 of the reference's;
    failed at step 5 and restarted from its own step-4 checkpoint (written
    and read on the mesh), step 5 within 1e-4 of the uninterrupted run."""
    want = runs["ref"]["loop/history"][3:]
    for meta in runs["meta"]:
        straight, restarted = meta["loop"]["straight"], \
            meta["loop"]["restarted"]
        assert straight["restarts"] == 0 and straight["completed"]
        np.testing.assert_allclose(straight["losses"], want, rtol=LOSS_RTOL)
        assert restarted["restarts"] == 1 and restarted["completed"]
        assert len(restarted["losses"]) == 1
        np.testing.assert_allclose(restarted["losses"],
                                   straight["losses"][-1:],
                                   rtol=RESUME_RTOL)
        assert straight["saved"] == restarted["saved"] == [2, 4, 5]


TP_TAGS = ("vocab", "hybrid", "encdec")
# what each TP case gathers over "model" a step: the kv heads' columns
# where n_kv does not divide the model axis, the hybrid's attention
# projections (5 heads over 4) and mamba's in_proj columns (its 8 SSM
# heads divide the axis: the rank's heads' columns, narrowed from in_proj
# gathered, as 128 tokens a rank outweigh d_model 64), and nothing else
# (no block's or the root's parameters)
TP_REDISTRIBUTED = {
    "f32": ["attention wk columns", "attention wv columns"],
    "vocab": ["attention wk columns", "attention wv columns"],
    "hybrid": ["attention wk output", "attention wo input",
               "attention wq output", "attention wv output",
               "mamba in_proj columns"],
    "encdec": [],
}


@pytest.mark.parametrize("tag", TP_TAGS)
def test_tp_train_step(runs, tag):
    """Two steps on 2 x 4 with TP over "model" (a vocab-parallel dense
    model, a hybrid whose attention heads do not divide and whose SSM
    heads do, an encoder-decoder) against
    the port's one-device steps and the reference's sharded ones: losses,
    grad norms, lr and the parameters; every rank's state the same."""
    port, ref = runs["port"][0], runs["ref"]
    for i in range(SPEC["steps"]):
        for k, tol in (("loss", LOSS_RTOL), ("grad_norm", LOSS_RTOL),
                       ("lr", LR_RTOL)):
            got = port[f"{tag}/{k}{i}"]
            np.testing.assert_allclose(got, port[f"{tag}/one/{k}{i}"],
                                       rtol=tol, err_msg=f"{k}{i}")
            np.testing.assert_allclose(got, ref[f"{tag}/{k}{i}"], rtol=tol,
                                       err_msg=f"{k}{i} vs reference")
    mine = _state(port, f"{tag}/state/")
    one = _state(port, f"{tag}/one/state/")
    theirs = _state(ref, f"{tag}/state/")
    for k, v in mine.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(v, one[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    for k, v in convert.train_state_to_jax(mine).items():
        if k.startswith("params/"):
            np.testing.assert_allclose(v, theirs[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    for r in range(1, WORLD):
        for k, v in _state(runs["port"][r], f"{tag}/state/").items():
            assert np.array_equal(v, mine[k]), (r, k)


@pytest.mark.parametrize("tag", ("f32",) + TP_TAGS)
def test_tp_step_collectives(runs, tag):
    """Each TP step all-reduces over "model" (the row-parallel outputs,
    the column-parallel inputs' gradients) and gathers over it only what
    its consumers need whole, by name: no parameter of a block or of the
    root is gathered over "model"."""
    for meta in runs["meta"]:
        for i in range(SPEC["steps"]):
            assert meta[f"{tag}/redistributed{i}"] == TP_REDISTRIBUTED[tag]
            c = meta[f"{tag}/counters{i}"]
            assert c.get("shard.redistribute_bytes", 0) > 0 \
                or not TP_REDISTRIBUTED[tag]
        if tag == "f32":
            assert all(meta[f"f32/model_all_reduces{i}"] > 0
                       for i in range(SPEC["steps"]))


def test_tp_ops_gradients(runs):
    """The TP ops in float64 on the 2 x 4 mesh against the unsplit
    products on the same inputs, every rank: the column / row pair, the
    kv heads' partial gather and pick, the activation gather and scatter;
    gradients within 1e-12."""
    for meta in runs["meta"]:
        assert sorted(meta["tp_ops"]) == ["copy_reduce", "gather",
                                          "gather_partial", "pick",
                                          "scatter"]
        for k, e in meta["tp_ops"].items():
            assert e <= 1e-12, (k, e)


def test_eight_bit_update_in_chunks_is_the_whole_leafs(runs):
    """An 8-bit moment's update on the mesh runs over the gathered leaf
    ``UPDATE_CHUNK`` values at a time: three steps of one expert leaf (a
    ragged last block) in chunks of 2 and of 7 blocks leave the
    parameter, codes and scales bitwise as the whole leaf's update does,
    on every rank."""
    assert all(meta["update_chunks_bitwise"] for meta in runs["meta"])


def test_tp_prefill(runs):
    """The vocab-split model's prefill on 2 x 4: each rank's logits are its
    rows' block of the vocabulary (4 x 16 x 24); gathered, they and the
    caches' k and v are the reference's sharded prefill's and the port's
    one-device prefill's within 2e-3."""
    for out, meta in zip(runs["port"], runs["meta"]):
        assert meta["prefill/logits_local"] == [4, 16, 24]
        for k in ("logits", "k", "v"):
            got = out[f"prefill/{k}"]
            np.testing.assert_allclose(got, out[f"prefill/one/{k}"],
                                       atol=DECODE_ATOL, rtol=0, err_msg=k)
            np.testing.assert_allclose(got, runs["ref"][f"prefill/{k}"],
                                       atol=DECODE_ATOL, rtol=0, err_msg=k)


def test_tp_vocab_decode(runs):
    """Three decode steps of the vocab-split model (n_kv 2 on model 4: the
    kv heads' columns gathered) on 2 x 4: logits gathered over the
    vocabulary and the rows, within 2e-3 of one device and of the
    reference, on every rank."""
    for out in runs["port"]:
        for i in range(3):
            got = out[f"vdecode/logits{i}"]
            np.testing.assert_allclose(got, out[f"vdecode/one/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
            np.testing.assert_allclose(got, runs["ref"][f"vdecode/logits{i}"],
                                       atol=DECODE_ATOL, rtol=0)
