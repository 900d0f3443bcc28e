"""One rank of the port's sharded-trainer tests: run as a script, one
process per rank of a gloo process group on the CPU (``python
tests/test_torch_shard_worker.py RANK WORLD DIR``); it holds no tests of its
own and imports no jax (the JAX package's side runs in a subprocess of its
own, ``tests/test_torch_shard.py``).

``DIR`` holds ``spec.json`` (configs, optimizer, data, step counts) and
``inputs.npz`` (the reference's initial parameters, ``init/<path>`` and
``decode/<path>``, and the other operands, drawn by the test from numpy
seeds); the rendezvous file is ``DIR/rdv``. Each rank writes
``DIR/rank<R>.npz`` (outputs) and ``DIR/rank<R>.json`` (per-rank facts:
state bytes, placements, counters). Two cases meet the reference's
subprocess half way through files: the port's checkpoint written on the
mesh for the reference to restore (``port_ckpt_jax``), and the
reference's checkpoint and its ``train_loop``'s for the port to restore
(``ref_ckpt``, ``ref_loop``); each side writes its own before it waits for
the other's.
"""
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

WAIT_S = 600


def _nested(flat, prefix):
    """{"a/b/c": x} under ``prefix`` -> {"a": {"b": {"c": x}}}."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = k[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _wait_for(path):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing at {path} after {WAIT_S} s")
        time.sleep(0.2)


def _flat_state(state):
    """The gathered state as a flat {key: numpy} map, the checkpoint's
    keys (every rank calls: the gathers are collective)."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.distributed import sharding as sh
    return {k: sh.full_tensor(v).detach().cpu().numpy()
            for k, v in ck._flatten(state).items()}


def _placements_ok(state, mesh):
    """Does every leaf sit at ``state_specs``' placements on ``mesh``?"""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.distributed import sharding as sh
    want = ck._flatten(sh.to_shardings(sh.state_specs(
        sh.state_shapes(state), mesh), mesh))
    got = ck._flatten(state)
    return sorted(want) == sorted(got) and all(
        got[k].device_mesh is mesh and
        tuple(got[k].placements) == want[k].placements for k in want)


def _moe_dropped(moe, x):
    """How many of a flat-dispatch moe layer's (token, k) assignments on
    the input ``x`` (B, S, d) land past its expert's capacity."""
    from repro_torch.models.moe import capacity
    cfg = moe.cfg
    with torch.no_grad():
        xt = x.reshape(-1, x.shape[-1]).float()
        ids = torch.topk(torch.softmax(xt @ moe.router.float(), -1),
                         cfg.top_k, -1).indices
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
        return int((counts - capacity(xt.shape[0], cfg)).clamp(min=0).sum())


def cfg_of(d):
    """A ModelConfig's keyword arguments from JSON (tuples come back as
    lists)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _tp_ops(mesh):
    """The TP ops on 8 ranks of ``mesh`` ("model" of 4) in float64 against
    the unsplit products on the same inputs: the largest gradient error
    of each pattern (this rank's blocks against the unsplit gradients'
    blocks)."""
    from repro_torch.distributed import sharding as sh
    f64 = torch.float64
    g = torch.Generator().manual_seed(7)
    x = torch.randn(6, 8, dtype=f64, generator=g)
    w = torch.randn(8, 12, dtype=f64, generator=g)
    v = torch.randn(8, 12, dtype=f64, generator=g)
    wo = torch.randn(12, 8, dtype=f64, generator=g)
    c = torch.randn(6, 8, dtype=f64, generator=g)
    n, r = 4, mesh.get_local_rank("model")
    tp = sh.TPSplit(mesh, 1, n, r)
    blk = lambda t, dim, i=r: t.chunk(n, dim)[i]           # noqa: E731
    kv = lambda i: slice((i // 2) * 6, (i // 2) * 6 + 6)   # noqa: E731

    def grads(fn, *leaves):
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        loss = (fn(*leaves) * c).sum()
        return torch.autograd.grad(loss, leaves)

    def err(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    def heads(xx, w_cols, v_cols, o_rows):
        o = torch.tanh(xx @ w_cols) * (xx @ v_cols).sum(-1, keepdim=True)
        return o @ o_rows

    out = {}
    # column / row pair: y = tanh(x W) Wo, W by columns, Wo by rows
    want = grads(lambda a, b, o: torch.tanh(a @ b) @ o, x, w, wo)
    got = grads(lambda a, b, o: tp.reduce(torch.tanh(tp.copy(a) @ b) @ o),
                x, blk(w, 1), blk(wo, 0))
    out["copy_reduce"] = err(got, (want[0], blk(want[1], 1),
                                   blk(want[2], 0)))
    # heads reading a kv block two ranks share: gathered columns (the
    # partial gather, a reduce-scatter back) or picked from a whole leaf
    def full(a, b, vv, o):
        return sum(heads(a, blk(b, 1, i), vv[:, kv(i)], blk(o, 0, i))
                   for i in range(n))
    want = grads(full, x, w, v, wo)
    got = grads(lambda a, b, vv, o: tp.reduce(heads(
        tp.copy(a), b, tp.gather(vv, "test", 1, partial=True)[:, kv(r)],
        o)), x, blk(w, 1), blk(v, 1), blk(wo, 0))
    out["gather_partial"] = err(got, (want[0], blk(want[1], 1),
                                      blk(want[2], 1), blk(want[3], 0)))
    got = grads(lambda a, b, vv, o: tp.reduce(heads(
        tp.copy(a), b, tp.pick(vv, 1, kv(r).start, kv(r).stop), o)),
        x, blk(w, 1), v, blk(wo, 0))
    out["pick"] = err(got, (want[0], blk(want[1], 1), want[2],
                            blk(want[3], 0)))
    # the activation gather (a whole consumer) and its inverse, the
    # scatter of a whole activation into a row-parallel product
    want = grads(lambda a, b, o: torch.tanh(a @ b) @ o, x, w, wo)
    got = grads(lambda a, b, o: torch.tanh(tp.gather(tp.copy(a) @ b,
                                                     "test")) @ o,
                x, blk(w, 1), wo)
    out["gather"] = err(got, (want[0], blk(want[1], 1), want[2]))
    got = grads(lambda a, b, o: tp.reduce(tp.scatter(torch.tanh(a @ b),
                                                     "test") @ o),
                x, w, blk(wo, 0))
    out["scatter"] = err(got, (want[0], want[1], blk(want[2], 0)))
    return out


def _mamba_cfg(spec, state):
    """The port-only Mamba-2 case's config at SSM state ``state``."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**cfg_of({**spec["cfg_mamba"], "ssm_state": state}))


def _mamba_model(cfg, seed):
    """``cfg``'s model with every parameter drawn from a numpy seed (no
    leaf uniform, so an entry picked wrong shows)."""
    from repro_torch.models import model_zoo
    model = model_zoo.build(cfg, "cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
        for blk in model.blocks:          # decays in (0, 1): A < 0, dt > 0
            blk.ssm.a_log.copy_(blk.ssm.a_log.abs().log1p())
    return model


def _mamba_heads(spec, mesh):
    """Mamba-2 by head on ``mesh`` (data 2, model 4; the port alone): one
    block of the ssm config, whose heads divide model 4, forward and
    backward on this rank's rows against one device's, in each route for
    in_proj's columns (``spec["mamba_routes"]``: picked from a whole
    in_proj, gathered as in_proj's columns, gathered as its output); the
    redistributed bytes by op, the TP all-reduces' bytes, this rank's
    in_proj block and the largest error of the output and of every
    gradient over its largest value."""
    from repro_torch import obs
    from repro_torch.distributed import sharding as sh
    from repro_torch.obs import counters
    meta = {}
    for route, (state, seq) in spec["mamba_routes"].items():
        cfg = _mamba_cfg(spec, state)
        one = _mamba_model(cfg, 9).blocks[0].ssm.requires_grad_(True)
        mine = sh.shard_model(_mamba_model(cfg, 9).blocks[0].ssm
                              .requires_grad_(True), mesh)
        rng = np.random.default_rng(10)
        b = spec["decode_batch"]
        xs = torch.from_numpy(rng.standard_normal(
            (b, seq, cfg.d_model)).astype(np.float32))
        c = torch.from_numpy(rng.standard_normal(
            (b, seq, cfg.d_model)).astype(np.float32))
        rows, ndp = sh.dp_rows(b, mesh), sh.dp_size(mesh)
        x1, xr = xs.requires_grad_(True), xs[rows].detach().requires_grad_(
            True)
        y1 = one(x1)
        ((y1 * c).sum() / ndp).backward()
        before = counters.snapshot()
        with obs.trace() as tr:
            y = mine(xr)
            (y * c[rows]).sum().backward()
        ctr = counters.delta(before)
        moved = {}
        for e in tr.spans("shard.redistribute"):
            moved[e.attrs["op"]] = moved.get(e.attrs["op"], 0) + \
                e.attrs["bytes"]
        want = dict(one.named_parameters())
        err = {"y": ((y - y1[rows]).abs().max() / y1.abs().max()).item(),
               "x": ((xr.grad - ndp * x1.grad[rows]).abs().max()
                     / (ndp * x1.grad).abs().max()).item()}
        for name, p in mine.named_parameters():
            g1 = want[name].grad
            err[name] = ((sh.full_tensor(p.grad) - g1).abs().max()
                         / g1.abs().max()).item()
        meta[route] = {"redistributed": moved,
                       "tp_all_reduce_bytes": ctr.get(
                           "shard.tp_all_reduce_bytes", 0),
                       "in_proj_local": list(sh.local(mine.in_proj).shape),
                       "err": err}
    return meta


def _backward_records(cfg, state, batch, mesh, fresh):
    """One sharded step's forward on this thread inside a
    ``record_transport()`` scope and an obs trace, and its backward on
    this thread or on a fresh one (which starts with no ContextVars, as
    autograd's device thread does): (the forward's records, the
    backward's, the counters' deltas, and per obs event name the bytes
    its events carry and the counter's delta, the backward's alone
    beside the whole step's)."""
    import threading

    from repro_torch import obs
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.obs import counters
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    model = state["params"]
    params = list(optimizer.named_parameters(model).values())
    hook = ts._hook(sh.make_shard_fn(mesh), mesh, batch)
    rows = {k: sh.local(v) for k, v in batch.items()}
    before = counters.snapshot()
    with coll.record_transport() as moved, obs.trace() as tr:
        with torch.enable_grad():
            loss = ts._loss(model, rows, cfg, hook)
        n_fwd, n_events = len(moved), len(tr.events)
        mid = counters.snapshot()
        errors = []

        def backward():
            try:
                torch.autograd.grad(loss, params, allow_unused=True)
            except BaseException as e:              # noqa: BLE001
                errors.append(e)

        if fresh:
            th = threading.Thread(target=backward)
            th.start()
            th.join()
        else:
            backward()
        if errors:
            raise errors[0]
        bwd = counters.delta(mid)
    step = counters.delta(before)
    events = {}
    for name, counter in (("shard.redistribute", "shard.redistribute_bytes"),
                          ("shard.expert_exchange",
                           "shard.expert_exchange_bytes")):
        events[name] = {
            "bwd_events": sum(e.attrs["bytes"] for e in
                              tr.events[n_events:] if e.name == name),
            "bwd_counter": bwd.get(counter, 0),
            "events": sum(e.attrs["bytes"] for e in tr.spans(name)),
            "counter": step.get(counter, 0)}
    return moved[:n_fwd], moved[n_fwd:], step, events


def _leaves(tree, prefix=""):
    """{path: leaf} of a tree of mappings and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _decode_case(tag, model, smodel, cfg, mesh, toks, caches_of, out,
                 meta, seq_shard=True):
    """Decode ``toks`` (B, n) a step at a time on one device (``model``)
    and on ``mesh`` (``smodel``, the caches at cache_specs or, with
    ``seq_shard`` off, whole over "model"), from the caches
    ``caches_of()`` builds: each step's logits, counters, the decode ops'
    bytes by name (``shard.decode`` events), the redistributions' names
    and the bytes of ``decode caches`` and ``decode ssm state``; then
    each cache leaf gathered
    beside one device's, and each rank's local shape beside its spec's
    block."""
    from repro_torch import obs
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.obs import counters

    caches = caches_of()
    scaches = sh.place_caches(caches_of(), mesh, seq_shard=seq_shard)
    facts = {"counters": [], "ops": [], "redistributed": [],
             "decode_caches": [], "decode_state": []}
    for i in range(toks.shape[1]):
        want, _ = model_zoo.decode_step(model, toks[:, i:i + 1], cfg,
                                        caches, i)
        before = counters.snapshot()
        with obs.trace() as tr:
            got, _ = sh.decode_step(smodel, toks[:, i:i + 1], cfg, scaches,
                                    i)
        facts["counters"].append(counters.delta(before))
        ops = {}
        for e in tr.spans("shard.decode"):
            ops[e.attrs["op"]] = ops.get(e.attrs["op"], 0) + e.attrs["bytes"]
        facts["ops"].append(ops)
        moved = tr.spans("shard.redistribute")
        facts["redistributed"].append(sorted({e.attrs["op"] for e in moved}))
        for what, op in (("caches", "decode caches"),
                         ("state", "decode ssm state")):
            facts[f"decode_{what}"].append(sum(
                e.attrs["bytes"] for e in moved if e.attrs["op"] == op))
        out[f"{tag}/logits{i}"] = got.numpy()
        out[f"{tag}/one/logits{i}"] = want.numpy()
    mine, one = _leaves(scaches), _leaves(caches)
    facts["local"], facts["block"] = {}, {}
    for k, t in mine.items():
        facts["local"][k] = list(sh.local(t).shape)
        facts["block"][k] = [ix.stop - ix.start for ix in sh.local_index(
            t.shape, t.placements, t.device_mesh)]
        out[f"{tag}/cache/{k}"] = sh.full_tensor(t).numpy()
        out[f"{tag}/one/cache/{k}"] = one[k].numpy()
    meta[tag] = facts


def _record_view(recs):
    return [[t.kind, t.axis, t.bytes] for t in recs]


def _moe_layer(minit, mcfg):
    """The moe FFN of the moe model's first block, on its own."""
    from repro_torch.models import convert
    from repro_torch.models.moe import MoE
    layer = MoE(mcfg, device="cpu")
    layer.load_state_dict(convert.from_jax_params(
        minit, mcfg, "cpu").blocks[0].moe.state_dict())
    return layer


def _expert_inputs(fn, dims):
    """``fn()``'s result and the first operand of each expert product it
    ran (a bmm whose second operand is (E', d, d_expert), ``dims`` = (d,
    d_expert)), in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default \
                    and args[1].shape[1:] == dims:
                seen.append(args[0].detach().clone())
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn()
    return out, seen


def _moe_ep(minit, mcfg, x, mesh):
    """The moe FFN on its own, experts over "model" 4 on (data 2, model
    4): each rank's window of the capacity slots against the one-device
    buffer's (bitwise), the output and aux against one device's, and the
    router's and experts' gradients (the mean over the DP ranks, as a
    step takes it) against one device's."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.moe import capacity, slot_window
    dims = (mcfg.d_model, mcfg.d_expert)
    xs = torch.from_numpy(x["moe_ep/x"])
    c = torch.from_numpy(x["moe_ep/c"])
    n = xs.shape[0]
    one = _moe_layer(minit, mcfg).requires_grad_(True)
    mine = sh.shard_model(_moe_layer(minit, mcfg).requires_grad_(True), mesh)
    ndp = sh.dp_size(mesh)
    rows = sh.dp_rows(n, mesh)
    (y1, aux1), whole = _expert_inputs(lambda: one(xs), dims)
    (y, aux), windows = _expert_inputs(lambda: mine(
        xs[rows], sh.make_shard_fn(mesh)), dims)
    di, _ = coll.flat_index(mesh, sh.batch_axes(mesh))
    split = sh.TPSplit(mesh, 0, *sh._model_axis(mesh))
    e0, e1 = split.span(mcfg.n_experts)
    win = slot_window(capacity(xs.shape[0] * xs.shape[1], mcfg), ndp, di)
    meta = {"windows": [list(w.shape) for w in windows],
            "whole": [list(w.shape) for w in whole],
            "bitwise": len(windows) == len(whole) > 0 and all(
                torch.equal(w, b[e0:e1, win])
                for w, b in zip(windows, whole)),
            "slots_filled": sum(int((w.abs().sum(-1) > 0).sum())
                                for w in windows)}
    # a rank's loss is its rows' (the mean over the DP ranks is what the
    # step's gradients are); the aux loss is the global batch's on each
    (aux1 + (y1 * c).sum() / ndp).backward()
    (aux + (y * c[rows]).sum()).backward()
    grads = {name: (sh.full_tensor(p.grad) - dict(one.named_parameters())[
        name].grad).abs().max().item()
        for name, p in mine.named_parameters()}
    meta["grad_err"] = grads
    return meta, {"moe_ep/y": y.detach().numpy(),
                  "moe_ep/one/y": y1[rows].detach().numpy(),
                  "moe_ep/aux": aux.detach().numpy(),
                  "moe_ep/one/aux": aux1.detach().numpy()}


def _update_chunks(mesh):
    """An 8-bit moment's update of one (8, 64, 45) leaf on ``mesh`` (the
    experts' spec: 8 over "model", 64 over "data"; 45 x 64 x 8 values, not
    a whole number of 256-value blocks), three steps, run whole and in
    chunks of 2 blocks and of 7: are the parameter, codes and scales
    bitwise the same?"""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import AdamWConfig

    gen = torch.Generator().manual_seed(11)
    w = torch.randn(8, 64, 45, generator=gen)
    grads = [torch.randn(8, 64, 45, generator=gen) for _ in range(3)]
    spec = sh.param_spec("blocks/0/moe/w_in", w, mesh)

    def place(t, spec=spec):
        return sh.distribute(t, sh.NamedSharding(mesh, spec))

    def moment(mo):
        mspec = sh._moment_spec(mo, spec, mesh)
        return optimizer._Moment(*(place(t, ms) for t, ms in zip(mo, mspec)))

    cfg = AdamWConfig(lr=5e-3, eight_bit=True)
    chunk, got = sh.UPDATE_CHUNK, []
    try:
        for sh.UPDATE_CHUNK in (chunk, 2 * optimizer.Q_BLOCK,
                                7 * optimizer.Q_BLOCK):
            params = {"w": place(w)}
            zero = optimizer.init({"w": w}, cfg)
            state = {"step": place(zero["step"], sh.P()),
                     "m": {"w": moment(zero["m"]["w"])},
                     "v": {"w": moment(zero["v"]["w"])}}
            for g in grads:
                _, state, _ = optimizer.update({"w": place(g)}, state,
                                               params, cfg)
            got.append([sh.full_tensor(t) for t in (
                params["w"], *state["m"]["w"], *state["v"]["w"])])
    finally:
        sh.UPDATE_CHUNK = chunk
    return all(torch.equal(a, b) for other in got[1:]
               for a, b in zip(got[0], other))


def run(rank, world, d):
    from repro_torch import obs
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset, \
        make_batch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import elastic, sharding as sh
    from repro_torch.distributed.pipeline_parallel import \
        pipeline_forward, stack_stage_params
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import convert, model_zoo
    from repro_torch.models.config import ModelConfig
    from repro_torch.obs import counters
    from repro_torch.runtime.fault_tolerance import run_with_restarts
    from repro_torch.train import train_state as ts
    from repro_torch.train.optimizer import AdamWConfig

    spec = json.load(open(os.path.join(d, "spec.json")))
    x = dict(np.load(os.path.join(d, "inputs.npz")))
    out, meta = {}, {}
    # every rank makes every mesh, in one order
    mesh24 = make_debug_mesh(data=2, model=4)
    mesh42 = make_debug_mesh(data=4, model=2)
    pipe = make_mesh((2, 4), ("data", "stage"))
    meta["coord24"] = list(mesh24.get_coordinate())
    cfg = ModelConfig(**spec["cfg"])
    data = DataConfig(**spec["data"])
    init = _nested(x, "init")
    bshape = (data.global_batch, data.seq_len)
    tokens_sharding = sh.NamedSharding(mesh24, sh.batch_specs(
        {"tokens": bshape}, mesh24)["tokens"])

    # 1. the sharded train step on 2 x 4 (f32 and 8-bit moments) and the
    #    port's one-device step from the same state
    for tag, eight in (("f32", False), ("8bit", True)):
        opt = AdamWConfig(eight_bit=eight, **spec["opt"])
        state = sh.place_state(ts.state_for(convert.from_jax_params(
            init, cfg, "cpu"), opt), mesh24)
        one = ts.state_for(convert.from_jax_params(init, cfg, "cpu"), opt)
        meta[f"{tag}/bytes"] = [sh.local_bytes(state),
                                sh.spec_bytes(state, mesh24)]
        meta[f"{tag}/placed"] = _placements_ok(state, mesh24)
        step_fn = ts.make_train_step(cfg, opt, sh.make_shard_fn(mesh24))
        one_fn = ts.make_train_step(cfg, opt)
        for i in range(spec["steps"]):
            before = counters.snapshot()
            with coll.record_transport() as moved, obs.trace() as tr:
                state, m = step_fn(state, make_batch(
                    cfg, data, i, device="cpu", sharding=tokens_sharding))
            meta[f"{tag}/counters{i}"] = counters.delta(before)
            meta[f"{tag}/model_all_reduces{i}"] = sum(
                1 for t in moved if t.kind == "all_reduce"
                and t.axis == "model")
            meta[f"{tag}/redistributed{i}"] = sorted({
                e.attrs["op"] for e in tr.spans("shard.redistribute")})
            one, m1 = one_fn(one, make_batch(cfg, data, i, device="cpu"))
            for k in ("loss", "grad_norm", "lr"):
                out[f"{tag}/{k}{i}"] = m[k].numpy()
                out[f"{tag}/one/{k}{i}"] = m1[k].numpy()
        meta[f"{tag}/placed_after"] = _placements_ok(state, mesh24)
        for k, v in _flat_state(state).items():
            out[f"{tag}/state/{k}"] = v
        for k, v in _flat_state(one).items():
            out[f"{tag}/one/state/{k}"] = v
        if tag == "f32":
            # a checkpoint written on the mesh, for the reference to read
            path = ck.save(os.path.join(d, "port_ckpt"), spec["steps"],
                           state)
            if rank == 0:
                with np.load(os.path.join(path, "arrays.npz")) as f:
                    flat = convert.train_state_to_jax(dict(f))
                ck.save(os.path.join(d, "port_ckpt_jax"), spec["steps"],
                        flat)

    # 1b. TP on 2 x 4: a dense model whose vocabulary divides the model
    #     axis (vocab-parallel embedding, head and loss), a hybrid whose
    #     heads do not (q, k, v gathered) and whose in_proj does, and an
    #     encoder-decoder; each against the one-device steps
    tdata = DataConfig(**spec["data_tp"])
    for tag in ("vocab", "hybrid", "encdec"):
        tcfg = ModelConfig(**cfg_of(spec[f"cfg_{tag}"]))
        tinit = _nested(x, f"{tag}_init")
        opt = AdamWConfig(**spec["opt"])
        state = sh.place_state(ts.state_for(convert.from_jax_params(
            tinit, tcfg, "cpu"), opt), mesh24)
        one = ts.state_for(convert.from_jax_params(tinit, tcfg, "cpu"), opt)
        step_fn = ts.make_train_step(tcfg, opt, sh.make_shard_fn(mesh24))
        one_fn = ts.make_train_step(tcfg, opt)
        for i in range(spec["steps"]):
            batch = make_batch(tcfg, tdata, i, device="cpu",
                               sharding=tokens_sharding)
            whole = make_batch(tcfg, tdata, i, device="cpu")
            if tcfg.family == "encdec":
                whole["frames"] = torch.from_numpy(x[f"encdec/frames{i}"])
                batch["frames"] = sh.distribute(
                    whole["frames"], sh.NamedSharding(
                        mesh24, sh.batch_specs(whole, mesh24)["frames"]))
            before = counters.snapshot()
            with obs.trace() as tr:
                state, m = step_fn(state, batch)
            meta[f"{tag}/counters{i}"] = counters.delta(before)
            meta[f"{tag}/redistributed{i}"] = sorted({
                e.attrs["op"] for e in tr.spans("shard.redistribute")})
            one, m1 = one_fn(one, whole)
            for k in ("loss", "grad_norm", "lr"):
                out[f"{tag}/{k}{i}"] = m[k].numpy()
                out[f"{tag}/one/{k}{i}"] = m1[k].numpy()
        for k, v in _flat_state(state).items():
            out[f"{tag}/state/{k}"] = v
        for k, v in _flat_state(one).items():
            out[f"{tag}/one/state/{k}"] = v
    meta["tp_ops"] = _tp_ops(mesh24)
    meta["mamba"] = _mamba_heads(spec, mesh24)
    meta["update_chunks_bitwise"] = _update_chunks(mesh24)

    # 1c. a sharded step's backward on a fresh thread records what it
    #     records on this one (remat's recompute and every collective of
    #     the backward, in the scope of the forward); the dense model of
    #     case 1 and the moe model (its slot exchange)
    for tag, key, tcfg in (("f32", "init", cfg),
                           ("moe", "moe_init",
                            ModelConfig(**spec["cfg_moe"]))):
        opt = AdamWConfig(**spec["opt"])
        state = sh.place_state(ts.state_for(convert.from_jax_params(
            _nested(x, key), tcfg, "cpu"), opt), mesh24)
        batch = make_batch(tcfg, data, 0, device="cpu",
                           sharding=tokens_sharding)
        views = {}
        for fresh in (False, True):
            fwd, bwd, ctr, events = _backward_records(tcfg, state, batch,
                                                      mesh24, fresh)
            views[fresh] = {"fwd": _record_view(fwd),
                            "bwd": _record_view(bwd), "counters": ctr,
                            "events": events}
        meta[f"thread/{tag}"] = views

    # 2. global_batch: this rank's block of the step's tokens, and of the
    #    microbatches with accum 2
    ds = SyntheticDataset(data)
    out["gb/tokens"] = sh.local(ds.global_batch(
        3, tokens_sharding)).numpy()
    acc_sharding = sh.NamedSharding(mesh24, sh.batch_specs(
        {"tokens": (2, data.global_batch // 2, data.seq_len)}, mesh24,
        accum=2)["tokens"])
    out["gb/accum2"] = sh.local(make_batch(
        cfg, data, 3, accum=2, device="cpu",
        sharding=acc_sharding)["tokens"]).numpy()
    meta["gb/index"] = [[s.start, s.stop] for s in sh.local_index(
        bshape, tokens_sharding.placements, mesh24)]
    meta["gb/accum2_index"] = [[s.start, s.stop] for s in sh.local_index(
        (2, data.global_batch // 2, data.seq_len), acc_sharding.placements,
        mesh24)]

    # 3. sharded decode on 2 x 4: parameters at params_specs, f32 caches
    #    at cache_specs (the sequence's blocks of 16 over "model": the
    #    three steps' keys all in the first), against the one-device decode
    dcfg = ModelConfig(**spec["cfg_decode"])
    dparams = _nested(x, "decode")
    b, s = spec["decode_batch"], spec["decode_len"]
    model = convert.from_jax_params(dparams, dcfg, "cpu")
    smodel = sh.shard_model(convert.from_jax_params(dparams, dcfg, "cpu"),
                            mesh24)
    toks = torch.from_numpy(x["decode_tokens"])
    _decode_case("decode", model, smodel, dcfg, mesh24, toks,
                 lambda: model_zoo.init_caches(model, dcfg, b, s,
                                               dtype=torch.float32),
                 out, meta)
    # ... with seq_shard off: the caches whole over "model"
    _decode_case("wdecode", model, smodel, dcfg, mesh24, toks,
                 lambda: model_zoo.init_caches(model, dcfg, b, s,
                                               dtype=torch.float32),
                 out, meta, seq_shard=False)
    # ... and 3 rows, which do not divide "data": every rank runs them all
    _decode_case("odecode", model, smodel, dcfg, mesh24, toks[:3],
                 lambda: model_zoo.init_caches(model, dcfg, 3, s,
                                               dtype=torch.float32),
                 out, meta)

    # 3e. the hybrid (5 heads on model 4: q of every head gathered; its
    #     windowed layer's ring wrapping across the blocks; its 8 SSM
    #     heads' state each rank's 2-head block) on 2 x 4, and
    #     the encoder-decoder on 4 x 2 (its cross K / V split over model)
    hcfg = ModelConfig(**cfg_of(spec["cfg_hybrid"]))
    hinit = _nested(x, "hybrid_init")
    model = convert.from_jax_params(hinit, hcfg, "cpu")
    smodel = sh.shard_model(convert.from_jax_params(hinit, hcfg, "cpu"),
                            mesh24)
    htoks = torch.from_numpy(x["hdecode_tokens"])
    hs = spec["hybrid_decode_len"]
    _decode_case("hdecode", model, smodel, hcfg, mesh24, htoks,
                 lambda: model_zoo.init_caches(model, hcfg, b, hs,
                                               dtype=torch.float32),
                 out, meta)
    # ... and the ssm model whose in_proj is whole (its heads divide model
    #     4, its columns do not): the state its layers' head blocks
    scfg = _mamba_cfg(spec, spec["mamba_routes"]["pick"][0])
    model = _mamba_model(scfg, 11)
    smodel = sh.shard_model(_mamba_model(scfg, 11), mesh24)
    _decode_case("sdecode", model, smodel, scfg, mesh24,
                 htoks[:, :spec["mamba_decode_steps"]],
                 lambda: model_zoo.init_caches(model, scfg, b, hs,
                                               dtype=torch.float32),
                 out, meta)
    ecfg = ModelConfig(**cfg_of(spec["cfg_encdec"]))
    einit = _nested(x, "encdec_init")
    model = convert.from_jax_params(einit, ecfg, "cpu")
    smodel = sh.shard_model(convert.from_jax_params(einit, ecfg, "cpu"),
                            mesh42)
    memory = torch.from_numpy(x["edecode_memory"])
    _decode_case("edecode", model, smodel, ecfg, mesh42,
                 htoks[:, :spec["encdec_decode_steps"]],
                 lambda: model_zoo.init_caches(model, ecfg, b, s,
                                               memory=memory,
                                               dtype=torch.float32),
                 out, meta)

    # 3a. the vocab-split model's prefill (each rank its rows, logits its
    #     vocabulary block, gathered here) and decode on 2 x 4
    vcfg = ModelConfig(**cfg_of(spec["cfg_vocab"]))
    vinit = _nested(x, "vocab_init")
    model = convert.from_jax_params(vinit, vcfg, "cpu")
    smodel = sh.shard_model(convert.from_jax_params(vinit, vcfg, "cpu"),
                            mesh24)
    ptok = torch.from_numpy(x["prefill_tokens"])
    with torch.no_grad():
        logits, _, kv = sh.prefill(smodel, {"tokens": sh.distribute(
            ptok, tokens_sharding)}, vcfg)
        meta["prefill/logits_local"] = list(logits.shape)
        n = ptok.shape[0]
        out["prefill/logits"] = sh.gather_rows(sh.gather_logits(logits),
                                               mesh24, n).numpy()
        for k in ("k", "v"):
            out[f"prefill/{k}"] = sh.gather_rows(
                kv[k].transpose(0, 1), mesh24, n).transpose(0, 1).numpy()
        want = model_zoo.prefill(model, {"tokens": ptok}, vcfg)
    out["prefill/one/logits"] = want[0].numpy()
    for k in ("k", "v"):
        out[f"prefill/one/{k}"] = want[2][k].numpy()
    _decode_case("vdecode", model, smodel, vcfg, mesh24, toks,
                 lambda: model_zoo.init_caches(model, vcfg, b, s,
                                               dtype=torch.float32),
                 out, meta)

    # 3b. a moe model (capacity factor 1.25, as registered) with its
    #     experts sharded over "model" in E: each rank's rows of a forward
    #     against the one-device forward's, and two train steps against
    #     the one-device steps (the reference's sharded ones are the
    #     test's), the dispatch over the global batch on both
    mcfg = ModelConfig(**spec["cfg_moe"])
    minit = _nested(x, "moe_init")
    moe = convert.from_jax_params(minit, mcfg, "cpu")
    mtok = torch.from_numpy(x["moe_tokens"])
    with torch.no_grad():
        want, want_aux = model_zoo.forward(moe, {"tokens": mtok}, mcfg)
        smoe = sh.shard_model(convert.from_jax_params(minit, mcfg, "cpu"),
                              mesh24)
        meta["moe/experts_local"] = list(sh.local(
            smoe.blocks[0].moe.w_in).shape)
        rows = sh.dp_rows(mtok.shape[0], mesh24)
        got, got_aux = model_zoo.forward(smoe, {"tokens": mtok[rows]}, mcfg,
                                         shard_fn=sh.make_shard_fn(mesh24))
    out["moe/logits"], out["moe/one/logits"] = got.numpy(), \
        want[rows].numpy()
    out["moe/aux"], out["moe/one/aux"] = got_aux.numpy(), want_aux.numpy()
    # serving: prefill (each rank its rows) and three decode steps of the
    # whole batch (its rows split: 8 slots an expert, 4 a rank's window)
    one_moe = convert.from_jax_params(minit, mcfg, "cpu")
    with torch.no_grad():
        got = sh.prefill(smoe, {"tokens": sh.distribute(
            mtok, sh.NamedSharding(mesh24, sh.batch_specs(
                {"tokens": mtok}, mesh24)["tokens"]))}, mcfg)[0]
        out["moe/prefill"] = got.numpy()
        out["moe/one/prefill"] = model_zoo.prefill(
            one_moe, {"tokens": mtok}, mcfg)[0][rows].numpy()
    _decode_case("mdecode", one_moe, smoe, mcfg, mesh24, toks,
                 lambda: model_zoo.init_caches(one_moe, mcfg, b, s,
                                               dtype=torch.float32),
                 out, meta)
    opt = AdamWConfig(**spec["opt"])
    state = sh.place_state(ts.state_for(convert.from_jax_params(
        minit, mcfg, "cpu"), opt), mesh24)
    one = ts.state_for(convert.from_jax_params(minit, mcfg, "cpu"), opt)
    dropped = []
    for blk in one["params"].blocks:
        blk.moe.register_forward_hook(
            lambda mod, args, _out: dropped.append(_moe_dropped(mod,
                                                                args[0])))
    step_fn = ts.make_train_step(mcfg, opt, sh.make_shard_fn(mesh24))
    one_fn = ts.make_train_step(mcfg, opt)
    for i in range(spec["steps"]):
        before = counters.snapshot()
        with obs.trace() as tr:
            state, m = step_fn(state, make_batch(
                mcfg, data, i, device="cpu", sharding=tokens_sharding))
        meta[f"moe/counters{i}"] = counters.delta(before)
        moved = {}
        for e in tr.spans("shard.redistribute"):
            moved[e.attrs["op"]] = moved.get(e.attrs["op"], 0) + \
                e.attrs["bytes"]
        meta[f"moe/redistributed{i}"] = moved
        meta[f"moe/exchanges{i}"] = len(tr.spans("shard.expert_exchange"))
        one, m1 = one_fn(one, make_batch(mcfg, data, i, device="cpu"))
        for k in ("loss", "grad_norm", "lr"):
            out[f"moe/{k}{i}"] = m[k].numpy()
            out[f"moe/one/{k}{i}"] = m1[k].numpy()
    meta["moe/dropped_step0"] = dropped[:mcfg.n_layers]
    for k, v in _flat_state(state).items():
        out[f"moe/state/{k}"] = v
    for k, v in _flat_state(one).items():
        out[f"moe/one/state/{k}"] = v

    # 3c. the moe FFN alone with its experts over "model": the exchanged
    #     windows, the output and the gradients against one device
    meta["moe_ep"], got = _moe_ep(minit, mcfg, x, mesh24)
    out.update(got)

    # 3d. a grouped moe (each batch row its own group: no exchange), two
    #     steps against one device's (the reference's are the test's)
    gcfg = ModelConfig(**spec["cfg_moe_grouped"])
    ginit = _nested(x, "moe_grouped_init")
    state = sh.place_state(ts.state_for(convert.from_jax_params(
        ginit, gcfg, "cpu"), opt), mesh24)
    one = ts.state_for(convert.from_jax_params(ginit, gcfg, "cpu"), opt)
    step_fn = ts.make_train_step(gcfg, opt, sh.make_shard_fn(mesh24))
    one_fn = ts.make_train_step(gcfg, opt)
    for i in range(spec["steps"]):
        before = counters.snapshot()
        state, m = step_fn(state, make_batch(gcfg, data, i, device="cpu",
                                             sharding=tokens_sharding))
        meta[f"grouped/counters{i}"] = counters.delta(before)
        one, m1 = one_fn(one, make_batch(gcfg, data, i, device="cpu"))
        for k in ("loss", "grad_norm", "lr"):
            out[f"grouped/{k}{i}"] = m[k].numpy()
            out[f"grouped/one/{k}{i}"] = m1[k].numpy()
    for k, v in _flat_state(state).items():
        out[f"grouped/state/{k}"] = v
    for k, v in _flat_state(one).items():
        out[f"grouped/one/state/{k}"] = v

    # 4. the pipeline over the 4 stages of each data row
    per_stage = [{"w": torch.from_numpy(x[f"pipe/w{i}"]),
                  "b": torch.from_numpy(x[f"pipe/b{i}"])} for i in range(4)]
    stage_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])     # noqa: E731
    xm = torch.from_numpy(x["pipe/x"])
    out["pipe/y"] = pipeline_forward(stage_fn, pipe)(
        stack_stage_params(per_stage), xm).numpy()
    seq = xm
    for p in per_stage:
        seq = stage_fn(p, seq)
    out["pipe/seq"] = seq.numpy()

    # 5. elastic: a one-device checkpoint restored onto 4 x 2 (bitwise,
    #    at its specs), re-placed in memory onto 2 x 4, and back onto one
    #    device
    opt = AdamWConfig(eight_bit=False, **spec["opt"])
    plain = ts.state_for(convert.from_jax_params(init, cfg, "cpu"), opt)
    saved = _flat_state(plain)
    edir = os.path.join(d, "elastic")
    if rank == 0:
        ck.save(edir, 3, plain)
    dist.barrier()
    like = ts.state_for(model_zoo.build(cfg, "meta"), opt)
    got, step = elastic.elastic_restore(edir, like, mesh42)
    meta["elastic/step"] = step
    meta["elastic/placed42"] = _placements_ok(got, mesh42)
    meta["elastic/bitwise42"] = all(
        np.array_equal(v, saved[k]) for k, v in _flat_state(got).items())
    got = elastic.reshard_state(got, mesh24)
    meta["elastic/placed24"] = _placements_ok(got, mesh24)
    meta["elastic/bitwise24"] = all(
        np.array_equal(v, saved[k]) for k, v in _flat_state(got).items())
    back, _ = elastic.elastic_restore(edir, ts.state_for(
        model_zoo.build(cfg, "cpu"), opt), None)
    meta["elastic/bitwise1"] = all(
        np.array_equal(v, saved[k]) for k, v in _flat_state(back).items())

    # 6. the reference's sharded checkpoint restored on the port's mesh
    ref_ckpt = os.path.join(d, "ref_ckpt")
    _wait_for(os.path.join(ref_ckpt, "done"))
    if rank == 0:
        with np.load(os.path.join(ref_ckpt, f"step_{spec['steps']:010d}",
                                  "arrays.npz")) as f:
            ck.save(os.path.join(d, "ref_ckpt_port"), spec["steps"],
                    convert.train_state_from_jax(dict(f)))
    dist.barrier()
    like = ts.state_for(model_zoo.build(cfg, "meta"), opt)
    got, _ = ck.restore(os.path.join(d, "ref_ckpt_port"), like,
                        shardings=sh.to_shardings(sh.state_specs(
                            sh.state_shapes(like), mesh24), mesh24))
    meta["xref/placed"] = _placements_ok(got, mesh24)
    for k, v in _flat_state(got).items():
        out[f"xref/{k}"] = v

    # 7. train_loop on 2 x 4 from the reference's loop's step-2
    #    checkpoint: uninterrupted, and failed at step 5 then restarted
    loop_src = os.path.join(d, "ref_loop")
    _wait_for(os.path.join(loop_src, "done"))
    runs = {}
    for name in ("straight", "restarted"):
        cdir = os.path.join(d, f"loop_{name}")
        if rank == 0:
            with np.load(os.path.join(loop_src, "step_0000000002",
                                      "arrays.npz")) as f:
                ck.save(cdir, 2, convert.train_state_from_jax(dict(f)))
        dist.barrier()
        calls, hist = [], []

        def loop(resume, cdir=cdir, name=name, calls=calls, hist=hist):
            calls.append(resume)
            fail = 5 if name == "restarted" and len(calls) == 1 else -1
            hist[:] = train_loop(
                cfg, AdamWConfig(**spec["opt"]), data, mesh24,
                steps=spec["loop_steps"], ckpt_dir=cdir, save_interval=2,
                log_every=100, fail_at_step=fail)[1]
            return spec["loop_steps"]

        report = run_with_restarts(loop, max_restarts=2)
        runs[name] = {"losses": hist, "restarts": report.restarts,
                      "completed": report.completed,
                      "saved": ck.all_steps(cdir)}
    meta["loop"] = runs

    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                            rank=rank, world_size=world)
    try:
        run(rank, world, d)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
