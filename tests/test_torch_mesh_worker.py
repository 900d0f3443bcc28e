"""One rank of the port's mesh tests: run as a script, one process per rank
of a gloo process group on the CPU (``python tests/test_torch_mesh_worker.py
RANK WORLD DIR``); it holds no tests of its own. It imports no jax: the JAX
package's side of the same cases runs in a subprocess of its own
(``tests/test_torch_mesh.py``).

``DIR`` holds ``specs.json`` (the cases, in order) and ``inputs.npz``
(their operands, drawn by the test from a numpy seed); the rendezvous file
is ``DIR/rdv``. Each rank writes ``DIR/rank<R>.npz`` (every output array,
``<case id>/<name>``) and ``DIR/rank<R>.json`` (per case: the
``record_collectives()`` list, the counter deltas, the ``collective.*``
events of an ``obs.trace`` around the call, and the B1 launches' variants
beside the ones ``gemm_variant`` names for their operands). A
case whose mesh does not hold the rank writes nothing for it, and every
rank makes every mesh, in the same order (the sub-groups are made
collectively).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _mesh(spec, meshes):
    from repro_torch.blas.distributed import make_blas_mesh
    key = tuple(spec["mesh"])
    if key not in meshes:
        meshes[key] = make_blas_mesh(*key)
    return meshes[key]


def _records(rec):
    return [dataclasses.asdict(r) for r in rec]


def _launch_log():
    """Wrap the dispatcher's GEMM executor so every B1 call records [the
    variant ``gemm_variant`` names for its operands, the variant it ran]
    (the CPU route launches nothing; ``last_launch`` records the
    choice)."""
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td
    log = []
    inner = td._gemm_exec

    def logged(a, b, res):
        out = inner(a, b, res)
        if res.use_pallas and 0 not in a.shape and 0 not in b.shape:
            bb = b[:, None] if b.ndim == 1 else b
            log.append([gk.gemm_variant(a, bb),
                        gk.gemm.last_launch["variant"]])
        return out

    td._gemm_exec = logged
    return log


def _factored(r):
    """A FactorizationResult's arrays by name."""
    out = {"factors": r.factors}
    if r.pivots is not None:
        out["pivots"] = r.pivots
    if r.tau is not None:
        out["tau"] = r.tau
    return out


def run_case(spec, x, meshes, registry):
    """Outputs of one case as {name: tensor}; None where the rank is not
    in the case's mesh."""
    from repro_torch import linalg
    from repro_torch.blas import distributed as dblas
    from repro_torch.distributed import collectives as coll
    from repro_torch.lapack import distributed as dlap
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.linalg import context as lctx
    from repro_torch.tune import dispatch as td
    op = spec["op"]
    t = lambda name: torch.from_numpy(x[f"{spec['id']}/{name}"])
    kw = {"policy": spec.get("policy", "reference")}
    if kw["policy"] == "tuned":
        kw["registry"] = registry
    if op in ("grad_sync", "decode"):
        key = op
        if key not in meshes:
            meshes[key] = (make_debug_mesh(data=1, model=1, pod=8)
                           if op == "grad_sync"
                           else make_debug_mesh(data=2, model=4))
        mesh = meshes[key]
    elif op == "linalg":
        mesh = lctx.resolved_mesh(lctx.ExecutionContext(
            mesh=tuple(spec["mesh"])))
    else:
        mesh = _mesh(spec, meshes)
    if mesh.get_coordinate() is None:
        return None
    if op == "pdgemm":
        extra = {}
        if "alpha" in spec:
            extra = dict(c=t("c"), alpha=spec["alpha"], beta=spec["beta"])
        return {"out": dblas.pdgemm(t("a"), t("b"), mesh, **extra, **kw)}
    if op == "dispatch_pdgemm":
        return {"out": td.dispatch("pdgemm", t("a"), t("b"), mesh=mesh,
                                   **kw)}
    if op == "pdtrsm":
        return {"out": dblas.pdtrsm(t("t"), t("b"), mesh,
                                    lower=spec["lower"], left=spec["left"],
                                    **kw)}
    if op in ("potrf", "getrf", "geqrf"):
        return _factored(getattr(dlap, "batched_" + op)(t("a"), mesh, **kw))
    if op == "solve":
        r = getattr(dlap, "batched_" + spec["kind"])(t("a"), mesh, **kw)
        return {"x": dlap.batched_solve(r, t("rhs"), mesh, **kw)}
    if op == "grad_sync":
        sync = coll.compressed_grad_sync(mesh, "pod")
        g = {"w": t("g")}
        e = {"w": torch.zeros_like(g["w"])}
        out = {}
        for s in range(spec["steps"]):
            o, e = sync(g, e)
            out[f"mean{s}"], out[f"err{s}"] = o["w"], e["w"]
        return out
    if op == "decode":
        attn = coll.sharded_decode_attention(mesh, ("data",))
        kv = spec["kv_len"]
        kv = t("kv_len") if kv == "rows" else kv
        return {"out": attn(t("q"), t("k"), t("v"), kv)}
    if op == "linalg":
        with linalg.use(device="cpu", mesh=tuple(spec["mesh"]), **kw):
            fn = spec["fn"]
            if fn == "gemm":
                return {"out": linalg.gemm(t("a"), t("b"), transa=True)}
            if fn == "syrk":
                return {"out": linalg.syrk(t("a"))}
            if fn == "trsm":
                return {"out": linalg.trsm(t("t"), t("b"))}
            r = getattr(linalg, fn)(t("a"))
            out = _factored(r)
            if fn == "batched_lu":
                out["x"] = linalg.batched_solve(r, t("rhs"))
            return out
    raise ValueError(f"unknown case op {op!r}")


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                            rank=rank, world_size=world)
    from repro_torch import obs
    from repro_torch.distributed import collectives as coll
    from repro_torch.obs import counters
    with open(os.path.join(d, "specs.json")) as f:
        specs = json.load(f)
    from repro_torch.tune.registry import Registry
    registry = Registry(path=os.path.join(d, "no-registry.json"))  # cold
    registry.lookup("gemm", (1, 1, 1), "float32", "cpu")  # load it now
    with np.load(os.path.join(d, "inputs.npz")) as data:
        x = {k: data[k] for k in data.files}
    meshes, arrays, meta = {}, {}, {}
    log = _launch_log()
    for spec in specs:
        before = counters.snapshot()
        del log[:]
        with coll.record_collectives() as rec, obs.trace() as tr:
            out = run_case(spec, x, meshes, registry)
        if out is None:
            continue
        meta[spec["id"]] = {"records": _records(rec),
                            "counters": counters.delta(before),
                            "variants": list(log),
                            "events": [[e.name, e.attrs] for e in tr.events
                                       if e.name.startswith("collective.")]}
        for name, v in out.items():
            arrays[f"{spec['id']}/{name}"] = v.numpy()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
