"""repro_torch.analysis's CC / SH / BY rules.

The record-level tests carry the names of ``tests/test_analysis_spmd.py``'s:
the reference feeds its linters synthetic jaxprs, the port's linters read
run-time records (``CollectiveRecord``, ``TransportRecord``, counter
deltas), built here by hand. One spawn of 8 gloo CPU ranks runs
``check_distributed`` on the three acceptance meshes and the surface's mesh
legs, both clean, then doctors the gathered records of a real (2, 2)
``pdgemm`` so CC001, CC002 and CC003 fire. The BY001 tests trace the model
zoo on fake CUDA tensors and hold the committed burn-down list to the
reference's (each port site maps to a reference site or names the
difference). No jax is imported.
"""
import json
import multiprocessing as mp
import os
import pickle
import tempfile
import warnings

import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import bypass_lint, report, spmd_lint
from repro_torch.distributed.collectives import (CollectiveRecord,
                                                 TransportRecord)

REF_ALLOWLIST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro", "analysis",
    "bypass_allowlist.json")


def _rules_of(findings):
    return {f.rule for f in findings}


# ------------------------------- CC001 --------------------------------------

def _links(pairs):
    """{rank: (send_to, recv_from)} from (src, dst) pairs."""
    recv = {d: s for s, d in pairs}
    return {s: (d, recv.get(s)) for s, d in pairs}


def _ring_pairs(size):
    return [(r, (r + 1) % size) for r in range(size)]


def test_cc001_clean_ring_is_silent():
    assert spmd_lint.lint_ring(range(4), _links(_ring_pairs(4)), "y") == []


def test_cc001_self_send_fires():
    f = spmd_lint.lint_ring([0, 1], _links([(0, 0), (1, 1)]), "y")
    assert _rules_of(f) == {"CC001"} and "self-send" in f[0].message


def test_cc001_duplicate_endpoint_fires():
    f = spmd_lint.lint_ring([0, 1, 2], {0: (1, 2), 1: (0, 0), 2: (0, 1)},
                            "y")
    assert _rules_of(f) == {"CC001"} and "bijection" in f[0].message


def test_cc001_partial_coverage_fires():
    f = spmd_lint.lint_ring(range(4), _links([(0, 1), (1, 0)]), "y")
    assert _rules_of(f) == {"CC001"} and "2 of 4" in f[0].message


def test_cc001_multi_cycle_fires():
    f = spmd_lint.lint_ring(range(4), _links([(0, 1), (1, 0), (2, 3),
                                              (3, 2)]), "y")
    assert _rules_of(f) == {"CC001"} and "cycles" in f[0].message


def test_cc001_receiver_must_name_its_sender():
    links = _links(_ring_pairs(4))
    links[2] = (3, 0)                    # rank 2 listens to 0, not 1
    f = spmd_lint.lint_ring(range(4), links, "y")
    assert _rules_of(f) == {"CC001"} and "another sender" in f[0].message


def _hop(rank, group, send_to, recv_from, hops=None, axis="y", nbytes=64):
    hops = len(group) - 1 if hops is None else hops
    return TransportRecord(kind="hop", rank=rank, axis=axis,
                           group=tuple(group), index=group.index(rank),
                           send_to=send_to, recv_from=recv_from, hops=hops,
                           bytes=hops * nbytes)


def test_cc001_fires_through_the_gathered_hop_records():
    # the ring is assembled from each rank's own record of its links
    group = [4, 5, 6, 7]
    hops = [_hop(r, group, group[(i + 1) % 4], group[(i - 1) % 4])
            for i, r in enumerate(group)]
    assert spmd_lint.lint_rings(hops) == []
    hops[1] = _hop(5, group, 4, 4)       # 5 sends back to 4: two cycles
    assert "CC001" in _rules_of(spmd_lint.lint_rings(hops))
    assert "disagree" in spmd_lint.lint_rings(hops[:3])[0].message


# ------------------------------- SH001 --------------------------------------

def _part(padded, spec, block, mesh=None, shape=None):
    return TransportRecord(kind="partition", rank=0, info={
        "routine": "pdgemm", "operand": "a", "shape": shape or padded,
        "padded": padded, "spec": spec, "mesh": mesh or {"x": 2, "y": 2},
        "block": block})


def test_sh001_clean_spec_is_silent():
    p = _part([4, 6], {0: ["x"], 1: ["y"]}, [2, 3])
    assert spmd_lint.lint_partitions([p]) == []


def test_sh001_non_divisible_dim_fires():
    f = spmd_lint.lint_partitions([_part([3, 4], {0: ["x"]}, [1, 4])])
    assert _rules_of(f) == {"SH001"} and "not divisible" in f[0].message


def test_sh001_spec_beyond_rank_fires():
    f = spmd_lint.lint_partitions([_part([4, 4], {2: ["x"]}, [4, 4])])
    assert _rules_of(f) == {"SH001"} and "rank-2" in f[0].message


def test_sh001_unknown_mesh_axis_fires():
    f = spmd_lint.lint_partitions([_part([4, 4], {0: ["z"]}, [4, 4])])
    assert _rules_of(f) == {"SH001"} and "absent from the mesh" in \
        f[0].message


def test_sh001_wrong_block_fires():
    f = spmd_lint.lint_partitions([_part([4, 4], {0: ["x"]}, [4, 4])])
    assert _rules_of(f) == {"SH001"} and "block" in f[0].message


# ------------------------------- SH003 --------------------------------------

def _gather(tag, group=(0, 1)):
    return TransportRecord(kind="all_gather", rank=0, axis="y",
                           group=tuple(group), tag=tag, bytes=64)


def test_sh003_all_gather_inside_the_body_warns():
    f = spmd_lint.lint_replication([_gather("body")])
    assert _rules_of(f) == {"SH003"} and f[0].severity == "warn"


def test_sh003_result_gather_is_silent():
    assert spmd_lint.lint_replication([_gather("result")]) == []
    assert spmd_lint.lint_replication([_gather("body", group=(0,))]) == []


# ------------------------------- CC002 --------------------------------------

def _ring_record(size=4, hops=None, axis="y", per_hop=64):
    hops = size - 1 if hops is None else hops
    return CollectiveRecord(kind="ring_bcast", axis=axis, size=size,
                            src=0, hops=hops, per_hop_bytes=per_hop,
                            wire_bytes=per_hop * hops)


def _loop(hops=3, nbytes=64, axis="y"):
    return _hop(0, [0, 1, 2, 3], 1, 3, hops=hops, axis=axis, nbytes=nbytes)


def test_cc002_recorded_hops_must_be_size_minus_one():
    f = spmd_lint.lint_collective_records([_ring_record(hops=2)],
                                          [_loop(hops=2)])
    assert "CC002" in _rules_of(f)
    assert any("size - 1 = 3" in x.message for x in f)


def test_cc002_loops_must_match_records():
    # the schedule declares 3 hops on "y"; the ring loop made 2
    f = spmd_lint.lint_collective_records([_ring_record(size=4)],
                                          [_loop(hops=2)])
    assert any(x.rule == "CC002" and "made 2" in x.message for x in f)


def test_cc002_counter_delta_must_match_records():
    f = spmd_lint.lint_collective_records(
        [_ring_record(size=4)], [_loop()],
        counter_delta={"collective.hops": 5})
    assert any(x.rule == "CC002" and "counter" in x.message for x in f)


def test_cc002_consistent_schedule_is_silent():
    f = spmd_lint.lint_collective_records(
        [_ring_record(size=4, per_hop=64)], [_loop(nbytes=64)],
        counter_delta={"collective.hops": 3, "collective.bytes": 192})
    assert f == []


# ------------------------------- CC003 --------------------------------------

def test_cc003_counter_byte_drift_fires():
    f = spmd_lint.lint_collective_records(
        [_ring_record(size=2, hops=1, per_hop=64)],
        [_hop(0, [0, 1], 1, 1, hops=1, nbytes=64)],
        counter_delta={"collective.hops": 1, "collective.bytes": 128})
    assert any(x.rule == "CC003" and "counter" in x.message for x in f)


def test_cc003_plan_pdgemm_drift_fires():
    # a declared pdgemm schedule whose ring loops sent nothing: the
    # plan's collective term has nothing to match
    sched = CollectiveRecord(kind="pdgemm", size=4,
                             info={"m": 48, "n": 64, "k": 32, "px": 2,
                                   "py": 2, "kf": 8, "itemsize": 4,
                                   "dtype": "float32"})
    f = spmd_lint.lint_collective_records([sched])
    assert any(x.rule == "CC003" and "plan_pdgemm" in x.message for x in f)


# ------------------------------- SH002 --------------------------------------

def _pad_record(batch, pad, ndev, identity=True):
    return CollectiveRecord(kind="pad_batch", size=ndev,
                            info={"batch": batch, "pad": pad,
                                  "identity": identity})


def test_sh002_clean_pad_is_silent():
    f = spmd_lint.lint_collective_records(
        [_pad_record(2, 6, 8), _pad_record(8, 0, 8)])
    assert f == []


def test_sh002_non_multiple_pad_fires():
    f = spmd_lint.lint_collective_records([_pad_record(3, 2, 4)])
    assert _rules_of(f) == {"SH002"} and "not a" in f[0].message


def test_sh002_non_minimal_pad_fires():
    f = spmd_lint.lint_collective_records([_pad_record(3, 5, 4)])
    assert _rules_of(f) == {"SH002"} and "not minimal" in f[0].message


def test_sh002_non_identity_filler_fires():
    f = spmd_lint.lint_collective_records(
        [_pad_record(3, 1, 4, identity=False)])
    assert _rules_of(f) == {"SH002"} and "identity" in f[0].message


# ----------------------- 8 gloo ranks on the CPU -----------------------------

def _rank(rank, world, directory):
    """One rank: the clean sweeps, then (rank 0) the seeded violations on
    the gathered records of a real (2, 2) pdgemm."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import linalg
    from repro_torch.blas import distributed as dblas
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rdv",
                            rank=rank, world_size=world)
    out = {}
    with linalg.use(device="cpu"):
        rep = analysis.check_distributed(dtypes=("float32",))
        out["distributed"] = (rep.ok, rep.summary(), rep.cases)
        rep = analysis.check_surface(routines=["gemm", "batched_cholesky"],
                                     dtypes=("float32",),
                                     meshes=report.SURFACE_MESHES)
        out["surface"] = (rep.ok, rep.summary(), rep.cases)
        r = np.random.default_rng(0)
        a = torch.from_numpy(r.standard_normal((48, 32)).astype(np.float32))
        b = torch.from_numpy(r.standard_normal((32, 64)).astype(np.float32))
        mesh = report._leg_mesh((2, 2))
        caps = report._spmd_capture(
            (lambda: dblas.pdgemm(a, b, mesh, policy="model"))
            if rank < 4 else None)
        # check under a mesh context: every rank calls, rank 0 lints
        with linalg.use(policy="model", mesh=(2, 2)):
            rep = analysis.check(linalg.gemm, a.numpy(), b.numpy())
        out["check_on_mesh"] = (rep.ok, rep.summary(), rep.cases)
    if rank == 0:
        members = [c for c in caps if c["member"]]
        out["truthful"] = spmd_lint.lint_spmd(members, routine="pdgemm")
        out["n_hops"] = sum(t.kind == "hop" for c in members
                            for t in c["transport"])
        out["partitions"] = sum(t.kind == "partition" for c in members
                                for t in c["transport"])
        out["result_gathers"] = sum(t.kind == "all_gather"
                                    and t.tag == "result"
                                    for c in members for t in c["transport"])
        import dataclasses as dc
        bad = pickle.loads(pickle.dumps(members))
        i, t = next((i, t) for i, t in enumerate(bad[0]["transport"])
                    if t.kind == "hop" and t.send_to is not None)
        bad[0]["transport"][i] = dc.replace(t, send_to=0)   # self-send
        out["bad_ring"] = spmd_lint.lint_spmd(bad, routine="pdgemm")
        bad = pickle.loads(pickle.dumps(members))
        bad[0]["transport"][i] = dc.replace(t, hops=t.hops - 1,
                                            bytes=t.bytes // 2)
        out["bad_hops"] = spmd_lint.lint_spmd(bad, routine="pdgemm")
        with open(os.path.join(directory, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, 8, d)) for r in range(8)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(240)
        for p in procs:
            if p.is_alive():
                p.kill()
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            yield pickle.load(f)


def test_distributed_sweep_is_clean_on_every_mesh(ranks):
    ok, summary, cases = ranks["distributed"]
    assert ok and "0 error(s), 0 warning(s)" in summary, summary
    assert {tuple(c["mesh"]) for c in cases} == {(1, 1), (2, 2), (4, 2)}
    assert {c["routine"] for c in cases} == {"pdgemm", "pdtrsm"}
    assert len(cases) == 18 and not any("skipped" in c for c in cases)
    assert [c["ranks"] for c in cases[::6]] == [1, 4, 8]
    ok, summary, cases = ranks["surface"]
    assert ok and "0 error(s), 0 warning(s)" in summary, summary


def test_check_runs_spmd_rules_on_a_mesh_context(ranks):
    ok, summary, cases = ranks["check_on_mesh"]
    assert ok and "0 error(s), 0 warning(s)" in summary, summary
    assert cases == [{"routine": "gemm", "ranks": 4}]


def test_seeded_rings_fire_on_real_records(ranks):
    assert ranks["truthful"] == []
    # (2, 2): 4 steps x 2 rings x 4 ranks; a partition per operand and
    # rank; the two result gathers per rank
    assert ranks["n_hops"] == 32 and ranks["partitions"] == 8
    assert ranks["result_gathers"] == 8
    assert "CC001" in _rules_of(ranks["bad_ring"])
    assert {"CC002", "CC003"} <= _rules_of(ranks["bad_hops"])


# ------------------------------- BY001 --------------------------------------

def _raw_entry(name="raw"):
    def build():
        a = torch.empty((4, 4), device="cuda")

        def fn(x):
            return x @ x
        return fn, (a,), {}
    return [(name, build)]


def test_by001_fires_on_raw_contraction():
    rep = bypass_lint.lint_bypass(entries=_raw_entry(), allowlist=None)
    assert not rep.ok
    assert [f.rule for f in rep.findings] == ["BY001"]
    assert "mm" in rep.findings[0].message


def test_by001_dispatched_path_is_silent():
    def build():
        from repro_torch.tune import dispatch
        a = torch.empty((8, 8), device="cuda")
        res = dispatch.resolve("gemm", (8, 8, 8), a.dtype, policy="model",
                               backend="cuda")
        return (lambda x: dispatch._gemm_exec(x, x, res)), (a,), {}
    rep = bypass_lint.lint_bypass(entries=[("via-dispatch", build)],
                                  allowlist=None)
    assert rep.ok and not rep.findings and not rep.suppressed
    assert rep.cases == [{"entry": "via-dispatch", "contractions": 0,
                          "bypasses": 0}]


def test_by001_allowlist_round_trip(tmp_path):
    rep = bypass_lint.lint_bypass(entries=_raw_entry(), allowlist=None)
    site = rep.findings[0].location
    path = tmp_path / "by.json"
    path.write_text(json.dumps({
        "schema_version": 1, "rule": "BY001",
        "sites": [{"site": site, "reason": "test exemption"}]}))
    rep2 = bypass_lint.lint_bypass(entries=_raw_entry(),
                                   allowlist=str(path))
    assert rep2.ok and not rep2.findings
    assert rep2.suppressed[0].suppressed_by == f"allowlist:{path}"


def test_by001_corrupt_allowlist_warns_once_and_refires(tmp_path):
    path = tmp_path / "corrupt.json"
    path.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        rep = bypass_lint.lint_bypass(entries=_raw_entry(),
                                      allowlist=str(path))
    assert not rep.ok and rep.findings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert bypass_lint.load_bypass_allowlist(str(path)) == {}


def test_by001_missing_allowlist_is_silently_empty(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = bypass_lint.load_bypass_allowlist(str(tmp_path / "no.json"))
    assert got == {}


def test_by001_wrong_rule_allowlist_warns(tmp_path):
    path = tmp_path / "wrong.json"
    path.write_text(json.dumps({"schema_version": 1, "rule": "CM001",
                                "sites": []}))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert bypass_lint.load_bypass_allowlist(str(path)) == {}


def test_by001_committed_allowlist_covers_every_current_bypass():
    committed = bypass_lint.load_bypass_allowlist()
    assert len(committed) > 0 and all(committed.values())
    rep = bypass_lint.lint_bypass()
    broken = [c for c in rep.cases if "error" in c]
    assert not broken, broken
    assert rep.ok, "new bypass site(s):\n" + rep.summary()
    assert len(rep.suppressed) == len(committed)
    # B5 and B6 appear as launches, as the reference's kernel bodies do
    assert "repro_torch/kernels/flash_attention.py:attention" in committed
    assert "repro_torch/kernels/ssd_scan.py:ssd_scan" in committed


def test_by001_each_site_maps_to_a_reference_site_or_a_difference():
    ref = {e["site"] for e in json.load(open(REF_ALLOWLIST))["sites"]}
    port = json.load(open(bypass_lint.DEFAULT_ALLOWLIST_PATH))["sites"]
    for e in port:
        targets = e.get("reference", [])
        assert targets and set(targets) <= ref, e["site"]
        module, fn = e["site"].split(":")
        same = f"{module.replace('repro_torch/', 'repro/')}:{fn}"
        # a site whose module:function is not the reference's own names
        # the difference
        assert same in targets or e.get("difference"), e["site"]


# --------------------------- vocabulary plumbing ----------------------------

def test_spmd_rules_reachable_from_check_surface_defaults():
    assert report.SURFACE_MESHES == ((1, 1), (2, 2), (4, 2))
    assert tuple(report.DISTRIBUTED_ROUTINES) == ("pdgemm", "pdtrsm")


def test_allow_scope_suppresses_spmd_rule():
    from repro_torch.analysis.rules import apply_suppression
    with analysis.allow("SH002"):
        active, suppressed = apply_suppression(
            spmd_lint.lint_collective_records([_pad_record(3, 2, 4)]))
    assert not active and len(suppressed) == 1
    assert suppressed[0].suppressed_by == "allow()"


def test_mesh_legs_skip_without_a_process_group():
    rep = analysis.check_distributed(meshes=((2, 2),), dtypes=("float32",),
                                     policies=("model",))
    assert [c["skipped"] for c in rep.cases] == \
        ["needs 4 ranks (no process group)"] * 2
