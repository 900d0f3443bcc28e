"""repro_torch.launch.dryrun held to repro.launch.dryrun: tiny cells (2
layers, d_model 128) of hymba-1.5b, minitron-8b and qwen3-moe-235b-a22b
at train_4k, prefill_32k and decode_32k on the debug meshes (data 4,
model 1) and (data 2, model 2). Each side runs in its own subprocesses:
the reference's ``lower_cell`` on XLA host devices (its import asks for
512), the port's on a fake world of 4 ranks.

Per-chip flops are compared net of three documented differences, each
asserted on its own:

* **converts**: XLA's fused HLO holds a dtype ``convert`` once in every
  fusion that reads it, and the reference's ``hlo_cost`` counts each
  (decode reads the bf16 cache as f32 in several fusions); the port
  counts one ``_to_copy`` per cast. Both sides' converts are taken out.
* **the hybrid's conditional**: ``hlo_cost`` prices a ``conditional`` by
  its first branch, the windowed attention, so the reference counts
  hymba's global layer (layer 0 here) as windowed in train and prefill;
  the port's layer knows it is global and runs the blocked oracle over
  all pairs. At (data 4, model 1) the port is also traced at
  ``global_layers=()``, and the products' difference is asserted to be
  the global layer's extra pairs exactly. Those cells are compared net of
  the whole difference measured there; at (data 2, model 2) net of twice
  it, since a rank there runs twice the rows.
* **the decode-cache write**: at model 2 the cache's sequence is split
  over "model"; the reference writes the new token by ``select``s over
  the rank's whole block of k and v (two each), the port into one slot
  of the block that holds it (none on rank 0, which the trace follows:
  the last slot is the last rank's). The reference's selects are taken
  out and asserted to be 4 x B / data x S / model x Hkv x hd a layer
  exactly.

At model 2 the port runs TP over "model" (Megatron column and row
products, attention on each rank's heads where they divide, the
vocab-parallel embedding, head and loss, and hymba's SSM by head: 2 of
its 4 heads a rank), so every cell comes within 10 % of the reference's
flops a chip net of those differences; in train and prefill both sides
run hymba's attention core whole. Decode at model 2
runs flash-decoding on the rank's sequence block of the caches
(``sharding.decode_step``), as the reference's partitioner splits its
decode attention: every q head over S / model slots of each layer, so
the core's products a rank are 4 x B / data x Hq x hd x the layers'
cache lengths / model exactly, on every arch (hymba's 25 heads, which do
not divide the axis, too). The moe's experts
split over "model" in E and each DP rank multiplies its window of their
capacity slots, exchanged over the DP axes, as the reference's
partitioner splits the expert products over every chip: the port's
expert products are asserted to be E x C_pad x d x d_expert x 2 x
products x passes / 4 exactly, on both meshes.

The reference compiles at LLVM optimization level 0 on 8 host devices:
``hlo_cost`` reads the optimized HLO, which XLA's HLO passes make before
the LLVM backend runs (the rows are the same at the default level), and
the compile then takes about half the CPU time.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ARCHS = ("hymba-1.5b", "minitron-8b", "qwen3-moe-235b-a22b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = ((4, 1), (2, 2))
OVERRIDES = {"n_layers": 2, "d_model": 128}
WINDOWED = {"global_layers": ()}
PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce"}

_REFERENCE = textwrap.dedent("""
    import json, os, re, sys
    from repro.launch import dryrun
    # after the import, which asks for 512 devices; before jax starts
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_backend_optimization_level=0")
    from repro.launch.mesh import make_debug_mesh
    from repro.core import hlo_cost as hc

    def converts(text, want=lambda rec: rec.kind == "convert"):
        comps = hc.parse_module(text)
        def walk(name, scale, depth=0):
            total = 0.0
            for rec in comps.get(name, {}).values():
                k = rec.kind
                if depth > 32:
                    break
                if k == "while":
                    cond = comps.get(hc._attr(rec.line, "condition"), {})
                    total += walk(hc._attr(rec.line, "body"),
                                  scale * hc._trip_count(cond), depth + 1)
                elif k == "conditional":
                    br = re.findall(r"%([\\w.\\-]+)",
                                    rec.line.split("branch", 1)[-1]) \\
                        if "branch" in rec.line else []
                    if br:
                        total += walk(br[0], scale, depth + 1)
                elif k in ("call", "async-start", "fusion"):
                    callee = hc._attr(rec.line, "to_apply") or \\
                        hc._attr(rec.line, "calls")
                    if callee:
                        total += walk(callee, scale, depth + 1)
                elif want(rec):
                    n = 1
                    for d in rec.dims:
                        n *= d
                    total += scale * n
            return total
        return walk("ENTRY", 1.0)

    from repro.configs import registry
    arch = sys.argv[1]
    cfg = registry.get_config(arch)
    # a select over a decode cache's block (B, S, Hkv, hd): the
    # partitioner's write of one token into a sequence-split cache
    tail = (cfg.n_kv, cfg.hd)
    cache_select = lambda rec: (rec.kind == "select" and len(rec.dims) == 4
                                and tuple(rec.dims[2:]) == tail)
    out = {}
    for data, model in ((4, 1), (2, 2)):
        mesh = make_debug_mesh(data, model)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            c, row = dryrun.lower_cell(arch, shape, mesh,
                                       overrides=json.loads(sys.argv[2]))
            text = c.as_text()
            out[f"{data}x{model}/{shape}"] = {
                "kind": row.extra["kind"], "n_params": row.extra["n_params"],
                "n_active": row.extra["n_active"],
                "model_flops": row.model_flops, "flops": row.hlo_flops,
                "convert": converts(text),
                "cache_select": converts(text, cache_select)}
    print(json.dumps(out))
""")

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import registry
    from repro_torch.core import aten_cost
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import attention

    data, model, jobs = int(sys.argv[1]), int(sys.argv[2]), json.loads(
        sys.argv[3])
    dryrun.init_fake_world(4)
    mesh = make_debug_mesh(data, model, device_type="cpu")

    # the moe's expert products: the bmm over (E', ., .) operands (this
    # rank's experts) that hold both d and d_expert (forward, recompute
    # and both gradients)
    expert, dims = [0.0], [None]
    # the attention core's flops (its converts aside) and products: every
    # op inside the full-sequence core (ops.attention), decode's cached
    # one or its flash-decoding on a sequence block
    core, inside = [0.0, 0.0], [0]
    def scoped(fn):
        def run(*a, **k):
            inside[0] += 1
            try:
                return fn(*a, **k)
            finally:
                inside[0] -= 1
        return run
    attention.ops.attention = scoped(attention.ops.attention)
    attention.masked_decode_attention = scoped(
        attention.masked_decode_attention)
    from repro_torch.distributed import collectives
    collectives.block_decode_attention = scoped(
        collectives.block_decode_attention)
    op_cost = aten_cost.op_cost
    def counting(func, args, kwargs, out):
        c = op_cost(func, args, kwargs, out)
        name = aten_cost.base_name(func)
        if inside[0] and name != "_to_copy":
            core[0] += c.flops
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                core[1] += c.flops
        if dims[0] and aten_cost.base_name(func) == "bmm":
            x, y = (aten_cost._local(t) for t in args[:2])
            e, need = dims[0]
            if x.shape[0] == y.shape[0] == e and need <= {
                    *x.shape[1:], *y.shape[1:]}:
                expert[0] += c.flops
        return c
    aten_cost.op_cost = counting

    out = {}
    for label, arch, overrides, shapes in jobs:
        cfg = dataclasses.replace(registry.get_config(arch), **overrides)
        e = cfg.n_experts
        dims[0] = e and (e // model if e %% model == 0 else e, {
            cfg.d_model, cfg.d_expert or cfg.d_ff})
        for shape in shapes:
            expert[0] = core[0] = core[1] = 0.0
            trace, row = dryrun.lower_cell(arch, shape, mesh,
                                           overrides=overrides)
            records = {}
            for t in trace.transport:
                records[t.kind] = records.get(t.kind, 0) + t.bytes
            out.setdefault(label, {})[f"{data}x{model}/{shape}"] = {
                "kind": row.extra["kind"], "n_params": row.extra["n_params"],
                "n_active": row.extra["n_active"],
                "model_flops": row.model_flops, "flops": row.hlo_flops,
                "convert": sum(v[1] for k, v in trace.ops.items()
                               if k.startswith("aten::_to_copy")),
                "products": sum(v[1] for k, v in trace.ops.items()
                                if k in %r),
                "expert": expert[0], "core": core[0],
                "core_products": core[1],
                "coll": row.coll_breakdown, "records": records,
                "bytes_per_device": row.bytes_per_device,
                "state_bytes": trace.state_bytes,
                "spec_bytes": row.extra.get("spec_bytes"),
                "launches": len(trace.launches)}
    print(json.dumps(out))
""" % (PRODUCTS,))


def _start(code, *argv):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, argv)],
                            env=dict(os.environ, PYTHONPATH="src",
                                     JAX_PLATFORMS="cpu"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _read(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what}: {err[-3000:]}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sides():
    """{"ref": {arch: {cell: ...}}, "port": {...}, "windowed": {...}}: a
    reference subprocess an arch and a port one an (arch, mesh), started
    at once; hymba's at (data 4, model 1) also traces it windowed."""
    procs = {("ref", a): _start(_REFERENCE, a, json.dumps(OVERRIDES))
             for a in ARCHS}
    for a in ARCHS:
        for d, m in MESHES:
            jobs = [("port", a, OVERRIDES, SHAPES)]
            if a == "hymba-1.5b" and m == 1:
                jobs.append(("windowed", a, {**OVERRIDES, **WINDOWED},
                             ("train_4k", "prefill_32k")))
            procs[("port", a, d, m)] = _start(_PORT, d, m, json.dumps(jobs))
    out = {"ref": {}, "port": {}, "windowed": {}}
    for key, p in procs.items():
        got = _read(p, str(key))
        if key[0] == "ref":
            out["ref"][key[1]] = got
            continue
        for label, cells in got.items():
            out[label].setdefault(key[1], {}).update(cells)
    return out


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config(arch), **OVERRIDES)


def _expert_products(arch, shape, data):
    """The flops of every expert product of a step at the global batch's
    capacity, padded to a multiple of the DP ranks: E x C_pad x d x
    d_expert x 2 a product, 3 products with a glu (2 without), each run
    forward, recomputed and twice in the backward when training, a layer
    and a microbatch."""
    from repro_torch.configs import registry
    from repro_torch.models import moe
    cfg = _cfg(arch)
    spec = registry.SHAPE_BY_NAME[shape]
    kind = spec.kind
    accum = max(cfg.accum_steps, 1) if kind == "train" else 1
    tokens = spec.global_batch * (spec.seq_len if kind != "decode" else 1)
    cap = moe.padded_capacity(moe.capacity(tokens // accum, cfg), data)
    per = 2 * cfg.n_experts * cap * cfg.d_model * (cfg.d_expert or cfg.d_ff)
    passes = 4 if kind == "train" else 1     # forward, remat, backward x 2
    mats = 3 if cfg.glu else 2
    return per * mats * cfg.n_layers * passes * accum


def _global_extra(arch, shape, data):
    """The global layers' products beyond the windowed ones on a rank: the
    blocked oracle's S x S pairs against the banded one's S x 2w."""
    from repro_torch.configs import registry
    cfg = _cfg(arch)
    spec = registry.SHAPE_BY_NAME[shape]
    rows = spec.global_batch // data
    s, w = spec.seq_len, cfg.window
    n_global = sum(1 for i in cfg.global_layers if i < cfg.n_layers)
    passes = 4 if spec.kind == "train" else 1
    return 4 * rows * cfg.n_heads * cfg.hd * s * (s - 2 * w) * n_global \
        * passes


def _cache_lengths(arch, shape):
    """Each layer's decode cache length (a windowed layer's ring holds
    ``window`` slots)."""
    from repro_torch.configs import registry
    cfg = _cfg(arch)
    s = registry.SHAPE_BY_NAME[shape].seq_len
    return [s if cfg.window is None or i in cfg.global_layers
            else min(s, cfg.window) for i in range(cfg.n_layers)]


def _cache_select(arch, shape, data):
    """The reference's decode-cache write on a (data, 4 / data) mesh where
    "model" splits the cache's sequence: its HLO writes each of k and v
    with two selects over the rank's whole block (``dynamic_update_slice``
    partitioned), B / data x S / model x Hkv x hd each, a layer."""
    from repro_torch.configs import registry
    model = 4 // data
    spec = registry.SHAPE_BY_NAME[shape]
    if spec.kind != "decode" or model == 1:
        return 0.0
    cfg = _cfg(arch)
    rows = spec.global_batch // data
    return 4.0 * sum(rows * n // model * cfg.n_kv * cfg.hd
                     for n in _cache_lengths(arch, shape))


def _net(sides, arch, shape, data):
    """The port's flops on a (data, 4 / data) mesh less its converts and,
    for hymba's train and prefill, the global layer's extra flops: the
    module docstring's differences."""
    cell = sides["port"][arch][f"{data}x{4 // data}/{shape}"]
    net = cell["flops"] - cell["convert"]
    if arch == "hymba-1.5b" and shape != "decode_32k":
        full, windowed = (sides[s][arch][f"4x1/{shape}"]
                          for s in ("port", "windowed"))
        net -= (full["flops"] - windowed["flops"]) * 4 / data
    return net


def _ref_net(sides, arch, shape, data):
    """The reference's flops on a (data, 4 / data) mesh less its converts
    and its decode-cache selects."""
    cell = sides["ref"][arch][f"{data}x{4 // data}/{shape}"]
    return cell["flops"] - cell["convert"] - cell["cache_select"]


CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_exact_fields(sides, arch, shape, mesh):
    key = f"{mesh[0]}x{mesh[1]}/{shape}"
    mine, theirs = sides["port"][arch][key], sides["ref"][arch][key]
    for k in ("kind", "n_params", "n_active", "model_flops"):
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    assert mine["launches"] == 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_at_model_1(sides, arch, shape):
    ratio = _net(sides, arch, shape, 4) / _ref_net(sides, arch, shape, 4)
    assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_at_model_2(sides, arch, shape):
    """TP over "model": every cell within 10 % of the reference's flops a
    chip, net of the named differences."""
    ratio = _net(sides, arch, shape, 2) / _ref_net(sides, arch, shape, 2)
    assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cache_select_difference(sides, arch, shape, mesh):
    """The size of the reference's cache-write difference: at model 2 its
    decode writes the token by a select over the rank's whole block of
    the sequence-split cache (none elsewhere), exactly."""
    cell = sides["ref"][arch][f"{mesh[0]}x{mesh[1]}/{shape}"]
    assert cell["cache_select"] == _cache_select(arch, shape, mesh[0])


def test_whole_core_difference(sides):
    """The decode core is no longer whole anywhere: at (data 2, model 2) a
    rank's core products are its rows' q x K and P x V over every head
    and its block of each layer's cache (S / model slots), exactly, as
    the reference's partitioner reads its sequence block: hymba, whose
    25 heads do not divide the model axis, and every other arch alike."""
    from repro_torch.configs import registry
    rows = registry.SHAPE_BY_NAME["decode_32k"].global_batch // 2
    for arch in ARCHS:
        cfg = _cfg(arch)
        want = 4 * rows * cfg.n_heads * cfg.hd * sum(
            _cache_lengths(arch, "decode_32k")) // 2
        cell = sides["port"][arch]["2x2/decode_32k"]
        assert cell["core_products"] == want, (arch, cell["core_products"],
                                               want)
        assert 0 < cell["core_products"] <= cell["core"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_hybrid_conditional_difference(sides, shape):
    """The size of the conditional's difference: the port's products at
    hymba's own global layers less those at none are the global layer's
    S x (S - 2w) extra pairs, exactly."""
    key = f"4x1/{shape}"
    full = sides["port"]["hymba-1.5b"][key]
    windowed = sides["windowed"]["hymba-1.5b"][key]
    want = _global_extra("hymba-1.5b", shape, 4)
    assert full["products"] - windowed["products"] == \
        pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_expert_products_split_over_the_chips(sides, shape, mesh):
    """The moe's expert products a rank: a quarter of every expert slot's
    of the global batch, exactly (E / model experts, each on 1 / data of
    its padded capacity's slots), as the reference's partitioner splits
    them over the 4 chips."""
    arch = "qwen3-moe-235b-a22b"
    cell = sides["port"][arch][f"{mesh[0]}x{mesh[1]}/{shape}"]
    want = _expert_products(arch, shape, mesh[0]) / 4
    assert cell["expert"] == pytest.approx(want, rel=1e-9), \
        (cell["expert"], want)
    assert 0 < cell["expert"] < cell["products"]


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_difference_in_decode(sides, arch):
    """The size of the converts' difference where it matters, decode: the
    reference's fused converts of the cache are several times the port's
    one cast per read."""
    mine, theirs = (sides[s][arch]["4x1/decode_32k"] for s in ("port", "ref"))
    assert theirs["convert"] > 2 * mine["convert"] > 0
    assert theirs["convert"] > 0.2 * theirs["flops"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_collectives_are_the_ports_own(sides, arch, shape, mesh):
    """coll_breakdown (aten c10d operand bytes) equals what collectives'
    transport records say the step moved, kind by kind."""
    cell = sides["port"][arch][f"{mesh[0]}x{mesh[1]}/{shape}"]
    want = {k: 0 for k in cell["coll"]}
    for kind, b in cell["records"].items():
        want[KINDS[kind]] += b
    assert cell["coll"] == want
    assert sum(want.values()) > 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,shape", CELLS)
def test_memory_covers_the_state(sides, arch, shape, mesh):
    cell = sides["port"][arch][f"{mesh[0]}x{mesh[1]}/{shape}"]
    if shape == "train_4k":
        assert cell["state_bytes"] == cell["spec_bytes"]
    assert cell["bytes_per_device"] >= cell["state_bytes"] > 0


def test_all_skips_match_reference(tmp_path, capsys):
    """``main --all`` prints the reference's SKIP lines (every cell's row
    already cached, so nothing is traced)."""
    from repro.configs import registry as ref_registry
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun

    cells, _ = registry.all_cells()
    for a, s in cells:
        (tmp_path / f"{a}__{s}__pod.json").write_text("{}")
    dryrun.main(["--all", "--mesh", "pod", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    _, skipped = ref_registry.all_cells()
    assert [ln for ln in lines if ln.startswith("SKIP")] == \
        [f"SKIP {a} x {s}: {why}" for a, s, why in skipped]
    assert len([ln for ln in lines if ln.startswith("CACHED")]) == len(cells)


def test_model_axis_residual_writes_failed(tmp_path):
    """``--model-axis-residual`` on the pod mesh: the port refuses (its
    blocks run on the whole d), and the traceback goes to ``.FAILED``."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--mesh", "pod",
         "--model-axis-residual", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    tag = "mamba2-130m__decode_32k__pod"
    assert f"FAILED {tag}" in r.stdout
    text = (tmp_path / f"{tag}.FAILED").read_text()
    assert "model_axis_residual" in text and "ZeRO-3" in text
    assert not (tmp_path / f"{tag}.json").exists()


def test_no_fake_world_raises():
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="fake world"):
        dryrun.lower_cell("hymba-1.5b", "train_4k", {"data": 4, "model": 1})


def test_abstract_inputs_need_the_fake_mode():
    """Outside a FakeTensorMode the abstract state would allocate: it
    raises instead."""
    from repro_torch.launch import dryrun
    cfg = _cfg("minitron-8b")
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        dryrun.abstract_state(cfg, dryrun._opt_cfg(cfg))
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        dryrun.abstract_caches(cfg, 2, 16)
