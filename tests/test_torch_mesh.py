"""The port's mesh layer against the JAX package: SUMMA ``pdgemm`` /
``pdtrsm``, the batch-sharded LAPACK drivers, ``compressed_grad_sync``,
``sharded_decode_attention`` and ``linalg.use(mesh=...)``.

One module-scoped run does every case on both sides: the reference in a
subprocess with 8 fake host devices (``XLA_FLAGS``, as
``tests/test_distributed.py`` runs it), the port as 8 gloo CPU ranks
(``tests/test_torch_mesh_worker.py``, one process each, rendezvous through a
file), all from the same numpy inputs; the tests then read both sides'
outputs, ``record_collectives()`` lists, counter deltas and the
``collective.ring_bcast`` events of an ``obs.trace`` around each call
(priced against the ``ici_bw`` of the CPU's machine, ``tpu-like``, on
both sides).

Tolerances: results within ``dtype_tolerances`` (f32, scaled by the
problem as ``tests/test_distributed_blas.py`` scales them: 4 for GEMM, 8
for TRSM / QR, 16 for solves; 64 for the residual of a round trip);
the compressed mean within the same f32 bound of the reference's (both
sum the same int8 codes times the same scales, in another order); pivots,
records, events and counters exactly. Every rank of a mesh returns the same
result bitwise.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import dtype_tolerances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
MESHES = [(1, 1), (2, 2), (4, 2)]
POLICIES = ["reference", "model", "tuned"]
GEMM_SHAPES = [(32, 32, 32), (24, 20, 36)]      # divisible and ragged
BATCH = 6                                       # ragged vs 4 and 8 ranks
TIMEOUT = 600


def _specs_and_inputs():
    """The cases, in the order both sides run them, and their operands."""
    rng = np.random.default_rng(21)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    specs, x = [], {}

    def add(spec, **arrays):
        specs.append(spec)
        x.update({f"{spec['id']}/{k}": v for k, v in arrays.items()})

    for (m, n, k) in GEMM_SHAPES:
        a, b = f32(m, k), f32(k, n)
        for mesh in MESHES:
            for pol in POLICIES:
                add({"id": f"pdgemm-{m}x{n}x{k}-{mesh[0]}x{mesh[1]}-{pol}",
                     "op": "pdgemm", "mesh": mesh, "policy": pol}, a=a, b=b)
    add({"id": "pdgemm-epilogue", "op": "pdgemm", "mesh": (2, 2),
         "policy": "reference", "alpha": 0.5, "beta": -2.0},
        a=f32(16, 24), b=f32(24, 16), c=f32(16, 16))
    add({"id": "dispatch-pdgemm", "op": "dispatch_pdgemm", "mesh": (2, 2),
         "policy": "model"}, a=f32(16, 24), b=f32(24, 16))
    n, nrhs = 48, 10                       # nrhs ragged against every mesh
    t = np.tril(f32(n, n)) + 4.0 * np.eye(n, dtype=np.float32)
    b = f32(n, nrhs)
    for lower in (True, False):
        for mesh in MESHES:
            for pol in ("reference", "model"):
                add({"id": f"pdtrsm-{'lower' if lower else 'upper'}-"
                           f"{mesh[0]}x{mesh[1]}-{pol}", "op": "pdtrsm",
                     "mesh": mesh, "policy": pol, "lower": lower,
                     "left": True}, t=t if lower else t.T.copy(), b=b)
    add({"id": "pdtrsm-right", "op": "pdtrsm", "mesh": (4, 2),
         "policy": "model", "lower": True, "left": False}, t=t,
        b=b.T.copy())
    add({"id": "pdtrsm-vector", "op": "pdtrsm", "mesh": (4, 2),
         "policy": "model", "lower": True, "left": True}, t=t,
        b=b[:, 0].copy())
    nb, nn = BATCH, 24
    g = f32(nb, nn, nn)
    spd = g @ np.swapaxes(g, 1, 2) + nn * np.eye(nn, dtype=np.float32)
    rhs = f32(nb, nn)
    for mesh in MESHES:
        for pol in ("reference", "model"):
            tag = f"{mesh[0]}x{mesh[1]}-{pol}"
            add({"id": f"potrf-{tag}", "op": "potrf", "mesh": mesh,
                 "policy": pol}, a=spd)
            add({"id": f"getrf-{tag}", "op": "getrf", "mesh": mesh,
                 "policy": pol}, a=g)
            add({"id": f"solve-{tag}", "op": "solve", "kind": "getrf",
                 "mesh": mesh, "policy": pol}, a=g, rhs=rhs)
    add({"id": "geqrf-4x2-model", "op": "geqrf", "mesh": (4, 2),
         "policy": "model"}, a=g)
    add({"id": "solve-potrf-4x2", "op": "solve", "kind": "potrf",
         "mesh": (4, 2), "policy": "model"}, a=spd, rhs=rhs)
    add({"id": "grad-sync", "op": "grad_sync", "steps": 8}, g=f32(64, 64))
    bq, hq, hkv, s, d = 2, 8, 4, 256, 32
    add({"id": "decode", "op": "decode", "kv_len": 200}, q=f32(bq, hq, d),
        k=f32(bq, s, hkv, d), v=f32(bq, s, hkv, d))
    add({"id": "decode-rows", "op": "decode", "kv_len": "rows"},
        q=f32(bq, hq, d), k=f32(bq, s, hkv, d), v=f32(bq, s, hkv, d),
        kv_len=np.array([256, 17], np.int64))
    for fn in ("gemm", "syrk", "trsm", "batched_cholesky", "batched_lu",
               "batched_qr"):
        ops = {"gemm": dict(a=f32(36, 24), b=f32(36, 20)),
               "syrk": dict(a=f32(20, 28)),
               "trsm": dict(t=t, b=b),
               "batched_cholesky": dict(a=spd),
               "batched_lu": dict(a=g, rhs=rhs),
               "batched_qr": dict(a=g)}[fn]
        add({"id": f"linalg-{fn}", "op": "linalg", "fn": fn,
             "mesh": (2, 2), "policy": "model"}, **ops)
    return specs, x


# The JAX package's side: the same cases, its own calls, one trace each.
REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import linalg
    from repro.blas import distributed as dblas
    from repro.distributed import collectives as coll
    from repro.lapack import distributed as dlap
    from repro.launch.mesh import make_debug_mesh
    from repro import obs
    from repro.obs import counters
    from repro.tune import dispatch as td
    from repro.tune.registry import Registry

    d = sys.argv[1]
    specs = json.load(open(os.path.join(d, "specs.json")))
    x = dict(np.load(os.path.join(d, "inputs.npz")))
    registry = Registry(path=os.path.join(d, "ref-no-registry.json"))
    registry.lookup("gemm", (1, 1, 1), "float32", "cpu")   # load it now
    meshes, arrays, meta = {}, {}, {}

    def mesh_of(spec):
        key = tuple(spec["mesh"])
        if key not in meshes:
            meshes[key] = dblas.make_blas_mesh(*key)
        return meshes[key]

    def factored(r):
        out = {"factors": r.factors}
        if r.pivots is not None:
            out["pivots"] = r.pivots
        if r.tau is not None:
            out["tau"] = r.tau
        return out

    def run(spec):
        # each call is jitted: one trace emits its records and counters
        names = sorted(k.split("/", 1)[1] for k in x
                       if k.startswith(spec["id"] + "/"))
        kw = {"policy": spec.get("policy", "reference")}
        if kw["policy"] == "tuned":
            kw["registry"] = registry
        op = spec["op"]

        def body(*args):
            t = dict(zip(names, args)).__getitem__
            if op == "pdgemm":
                extra = {}
                if "alpha" in spec:
                    extra = dict(c=t("c"), alpha=spec["alpha"],
                                 beta=spec["beta"])
                return {"out": dblas.pdgemm(t("a"), t("b"), mesh_of(spec),
                                            **extra, **kw)}
            if op == "dispatch_pdgemm":
                return {"out": td.dispatch("pdgemm", t("a"), t("b"),
                                           mesh=mesh_of(spec), **kw)}
            if op == "pdtrsm":
                return {"out": dblas.pdtrsm(t("t"), t("b"), mesh_of(spec),
                                            lower=spec["lower"],
                                            left=spec["left"], **kw)}
            if op in ("potrf", "getrf", "geqrf"):
                return factored(getattr(dlap, "batched_" + op)(
                    t("a"), mesh_of(spec), **kw))
            if op == "solve":
                r = getattr(dlap, "batched_" + spec["kind"])(
                    t("a"), mesh_of(spec), **kw)
                return {"x": dlap.batched_solve(r, t("rhs"), mesh_of(spec),
                                                **kw)}
            if op == "linalg":
                with linalg.use(mesh=tuple(spec["mesh"]), **kw):
                    fn = spec["fn"]
                    if fn == "gemm":
                        return {"out": linalg.gemm(t("a"), t("b"),
                                                   transa=True)}
                    if fn == "syrk":
                        return {"out": linalg.syrk(t("a"))}
                    if fn == "trsm":
                        return {"out": linalg.trsm(t("t"), t("b"))}
                    r = getattr(linalg, fn)(t("a"))
                    out = factored(r)
                    if fn == "batched_lu":
                        out["x"] = linalg.batched_solve(r, t("rhs"))
                    return out
            raise ValueError(op)

        args = [jnp.asarray(x[spec["id"] + "/" + n]) for n in names]
        if op == "grad_sync":
            sync = jax.jit(coll.compressed_grad_sync(
                jax.make_mesh((8,), ("pod",)), "pod"))
            g = {"w": args[0]}
            e = {"w": jnp.zeros_like(g["w"])}
            out = {}
            for s in range(spec["steps"]):
                o, e = sync(g, e)
                out["mean%d" % s], out["err%d" % s] = o["w"], e["w"]
            return out
        if op == "decode":
            mesh = make_debug_mesh(data=2, model=4)
            attn = jax.jit(coll.sharded_decode_attention(mesh, ("data",)))
            q, k, v = (dict(zip(names, args))[n] for n in "qkv")
            with mesh:
                return {"out": attn(q, k, v, jnp.int32(spec["kv_len"]))}
        return jax.jit(body)(*args)

    for spec in specs:
        if spec["op"] == "decode" and spec["kv_len"] == "rows":
            continue                  # per-row lengths: the port's only
        before = counters.snapshot()
        with coll.record_collectives() as rec, obs.trace() as tr:
            out = run(spec)
        meta[spec["id"]] = {"records": [dataclasses.asdict(r) for r in rec],
                            "counters": counters.delta(before),
                            "events": [[e.name, e.attrs] for e in tr.events
                                       if e.name.startswith("collective.")]}
        for k, v in out.items():
            arrays[spec["id"] + "/" + k] = np.asarray(v)
    np.savez(os.path.join(d, "reference.npz"), **arrays)
    json.dump(meta, open(os.path.join(d, "reference.json"), "w"))
""")

SPECS, _ = _specs_and_inputs()
# per-row cache lengths are the port's only (the reference takes a scalar)
CASE_IDS = [s["id"] for s in SPECS if s.get("kv_len") != "rows"]
RANKS = {(1, 1): 1, (2, 2): 4, (4, 2): 8}


def _ranks(spec):
    """The world ranks that hold the case's mesh."""
    if spec["op"] in ("grad_sync", "decode"):
        return range(WORLD)
    return range(RANKS[tuple(spec["mesh"])])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    specs, x = _specs_and_inputs()
    with open(os.path.join(d, "specs.json"), "w") as f:
        json.dump(specs, f)
    np.savez(os.path.join(d, "inputs.npz"), **x)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    port_env = dict(env, OMP_NUM_THREADS="1")
    worker = os.path.join(ROOT, "tests", "test_torch_mesh_worker.py")
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
    load = lambda name: dict(np.load(os.path.join(d, name + ".npz")))
    meta = lambda name: json.load(open(os.path.join(d, name + ".json")))
    return {"specs": {s["id"]: s for s in specs}, "inputs": x,
            "ref": load("reference"), "ref_meta": meta("reference"),
            "port": [load(f"rank{r}") for r in range(WORLD)],
            "port_meta": [meta(f"rank{r}") for r in range(WORLD)]}


def _close(got, want, scale, msg=""):
    rtol, atol = dtype_tolerances(np.float32, scale)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


SCALES = {"pdgemm": 4.0, "dispatch_pdgemm": 4.0, "pdtrsm": 8.0,
          "potrf": 4.0, "getrf": 4.0, "geqrf": 8.0, "solve": 16.0,
          "grad_sync": 1.0, "decode": 1.0, "linalg": 16.0}


@pytest.mark.parametrize("case", CASE_IDS)
def test_case_matches_reference(runs, case):
    """Every output of the case within the tolerance of the reference's
    (integer outputs, the pivots, exactly), on every rank of its mesh,
    bitwise the same on all of them; the records field for field and the
    counter deltas of one call equal to one reference trace's."""
    spec = runs["specs"][case]
    names = [k for k in runs["ref"] if k.startswith(case + "/")]
    assert names, case
    ranks = list(_ranks(spec))
    for key in names:
        want = runs["ref"][key]
        got = runs["port"][0][key]
        assert got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.integer):
            assert np.array_equal(got, want), key
        else:
            _close(got, want, SCALES[spec["op"]], key)
        for r in ranks[1:]:
            assert np.array_equal(runs["port"][r][key], got), (key, r)
    want_meta = runs["ref_meta"][case]
    # the batched drivers run each rank's slab in lockstep, as the
    # reference's vmap: their dispatch and launch counters are the
    # reference's, not its times the items a rank holds
    want_counters = want_meta["counters"]
    for r in ranks:
        got_meta = runs["port_meta"][r][case]
        assert got_meta["records"] == want_meta["records"], (case, r)
        assert got_meta["counters"] == want_counters, (case, r)
        assert got_meta["events"] == want_meta["events"], (case, r)
    for r in range(ranks[-1] + 1, WORLD):
        assert case not in runs["port_meta"][r], (case, r)


def test_every_b1_launch_runs_the_variant_gemm_variant_names(runs):
    """The SUMMA panels (strided views of the shards, ragged kf) and
    pdtrsm's updates each run on the variant ``gemm_variant`` names, and
    the model / tuned cases launch B1 once per SUMMA step."""
    seen = 0
    for r, meta in enumerate(runs["port_meta"]):
        for case, m in meta.items():
            for named, ran in m["variants"]:
                assert named == ran, (case, r)
                seen += 1
            spec = runs["specs"][case]
            if spec["op"] == "pdgemm" and spec["policy"] != "reference":
                px, py = spec["mesh"]
                assert len(m["variants"]) == px * py, (case, r)
                assert m["counters"]["kernel.launch"] == px * py
    assert seen > 0


def test_summa_records_price_plan_pdgemm(runs):
    """One pdgemm call's ring_bcast wire bytes sum to plan_pdgemm's
    collective bytes, and the counters carry the same number."""
    from repro_torch.core import codesign
    for case, m in runs["port_meta"][0].items():
        spec = runs["specs"][case]
        if spec["op"] != "pdgemm":
            continue
        sched = m["records"][0]
        assert sched["kind"] == "pdgemm"
        info = sched["info"]
        plan = codesign.plan_pdgemm(info["m"], info["n"], info["k"],
                                    info["px"], info["py"],
                                    dtype_bytes=info["itemsize"])
        wire = sum(r["wire_bytes"] for r in m["records"][1:])
        assert wire == plan.collective_bytes, case
        assert m["counters"].get("collective.bytes", 0) == wire
        assert len(m["records"]) == 1 + 2 * plan.steps
        moving = [r for r in m["records"][1:] if r["hops"]]
        assert [a["wire_bytes"] for _, a in m["events"]] == \
            [r["wire_bytes"] for r in moving]
        for _, attrs in m["events"]:
            assert attrs["ici_bw"] == 50e9              # tpu-like's link
            assert attrs["modeled_s"] == attrs["wire_bytes"] / 50e9


def test_grad_sync_error_feedback(runs):
    """The reference test's properties on the port's 8 ranks: identical
    gradients come back within 2 % after one step, the residual is what
    quantization dropped, and feeding it back over 8 steps recovers the
    lost mass."""
    g = runs["inputs"]["grad-sync/g"]
    out = runs["port"][0]
    top = np.abs(g).max()
    rel = np.abs(out["grad-sync/mean0"] - g).max() / top
    assert rel < 0.02
    err = out["grad-sync/err0"]
    assert np.abs(err).max() > 0
    np.testing.assert_allclose(out["grad-sync/mean0"] + err, g,
                               atol=1e-6 * top)
    total = sum(out[f"grad-sync/mean{s}"] for s in range(8))
    assert np.abs(total / 8 - g).max() / top < rel


@pytest.mark.parametrize("case", ["decode", "decode-rows"])
def test_decode_matches_plain_attention(runs, case):
    """Flash-decoding over the sequence-sharded cache against attention
    over each row's first kv_len positions, in f64 (2e-4, the reference
    test's bound): one length for the batch, as the reference takes it,
    and one per row (a full row and one that ends inside the first
    shard); every rank returns the same output."""
    x = runs["inputs"]
    q, k, v = (x[f"{case}/{n}"].astype(np.float64) for n in "qkv")
    kv = runs["specs"][case]["kv_len"]
    lens = x[f"{case}/kv_len"] if kv == "rows" else [kv] * q.shape[0]
    g = q.shape[1] // k.shape[2]
    want = []
    for row, n in enumerate(lens):
        kh = np.repeat(k[row, :n], g, axis=1)
        vh = np.repeat(v[row, :n], g, axis=1)
        s = np.einsum("hd,shd->hs", q[row], kh) / np.sqrt(q.shape[-1])
        p = np.exp(s - s.max(-1, keepdims=True))
        want.append(np.einsum("hs,shd->hd", p / p.sum(-1, keepdims=True),
                              vh))
    got = runs["port"][0][f"{case}/out"]
    np.testing.assert_allclose(got, np.stack(want), atol=2e-4)
    for r in range(1, WORLD):
        assert np.array_equal(runs["port"][r][f"{case}/out"], got)


def test_mesh_batched_solve_round_trip(runs):
    """x from the batch-sharded potrf + solve solves the SPD systems."""
    x = runs["inputs"]
    a, rhs = x["solve-potrf-4x2/a"], x["solve-potrf-4x2/rhs"]
    got = runs["port"][0]["solve-potrf-4x2/x"]
    _close(np.einsum("bij,bj->bi", a, got), rhs, 64.0)
