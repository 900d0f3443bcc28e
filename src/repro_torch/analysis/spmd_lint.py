"""SPMD lint over the mesh's run-time records (CC and SH rules; port of
``repro.analysis.spmd_lint``).

The reference reads ``shard_map`` traces: ``ppermute`` permutations, specs,
and the ``all_gather`` / ``all_to_all`` equations inside a body. The port's
mesh has no traced SPMD program: each rank is a process that runs its part
(:mod:`repro_torch.distributed.collectives`). So the rules read what the
ranks did, recorded at run time and gathered to rank 0 after the call:

* :class:`~repro_torch.distributed.collectives.CollectiveRecord` - the
  declared schedule (``ring_bcast``, ``pdgemm``, ``pad_batch``), field for
  field the reference's;
* :class:`~repro_torch.distributed.collectives.TransportRecord` - each
  rank's actual ring links and hops (``"hop"``), its gathers
  (``"all_gather"``, the final result gathers tagged ``"result"``) and the
  operand partitions each mesh routine took (``"partition"``);
* the ``collective.hops`` / ``collective.bytes`` counter movement of each
  rank across the call.

Rules:

- **CC001**: the ring assembled from every rank's (send-to, receive-from)
  pair of one ``ring_bcast`` is one bijective cycle over the axis group:
  no self-send, no duplicate endpoint, every member covered, one cycle,
  and each receiver names its sender.
- **CC002**: each recorded ``ring_bcast`` declares ``size - 1`` hops, each
  rank's loops made exactly the declared hops per axis, and the records
  equal the ``collective.hops`` counter delta.
- **CC003**: the bytes each rank sent agree with ``collective.bytes`` and
  with ``plan_pdgemm``'s collective term, within the comm tolerance.
- **SH001**: each recorded partition is consistent with its shapes and the
  mesh (axes on the mesh, dims within rank, padded dims divisible by the
  axes' extent, the block taken is the padded dim over that extent).
- **SH002**: the ``pad_batch`` records pad to the minimal multiple with an
  identity filler.
- **SH003**: an ``all_gather`` / ``all_to_all`` inside a routine's body;
  the gather of a routine's final result (tagged ``"result"``) is a
  documented difference - the port returns the global result on every
  rank, the reference leaves it sharded - not a finding.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.analysis import rules
from repro_torch.analysis.rules import Finding, make_finding

REPLICATING = ("all_gather", "all_to_all")


def _drift(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(a), abs(b), 1.0)


# ------------------------------- CC001 --------------------------------------

def lint_ring(members: Sequence[int], links: Mapping[int, Tuple],
              axis: str, routine: Optional[str] = None) -> List[Finding]:
    """CC001 for one ring broadcast: ``links`` maps each member's global
    rank to the (send-to, receive-from) pair it used."""
    findings: List[Finding] = []
    perm = sorted((r, s) for r, (s, _) in links.items())

    def hit(msg):
        findings.append(make_finding(
            "CC001", f"ring over axis {axis!r} (ranks {list(members)}): "
            f"{msg} (links={perm})", routine=routine))

    self_sends = [p for p in perm if p[0] == p[1]]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if self_sends:
        hit(f"self-send pair(s) {self_sends} - a rank sending to itself "
            "deadlocks the ring")
        return findings
    if len(set(dsts)) != len(dsts):
        hit("duplicate destination - not a bijection")
        return findings
    if set(srcs) != set(members) or set(dsts) != set(members):
        hit(f"covers {len(set(srcs) & set(dsts))} of {len(members)} ring "
            "members - a rank outside the ring waits forever")
        return findings
    nxt = dict(perm)
    seen = {perm[0][0]}
    cur = nxt[perm[0][0]]
    while cur not in seen:
        seen.add(cur)
        cur = nxt[cur]
    if len(seen) != len(perm):
        hit(f"decomposes into multiple cycles ({len(seen)} of {len(perm)} "
            f"members reachable from {perm[0][0]})")
        return findings
    wrong = [(s, d, links[d][1]) for s, d in perm if links[d][1] != s]
    if wrong:
        hit(f"receivers name another sender: {wrong} (sender, receiver, "
            "named)")
    return findings


def lint_rings(hops: Sequence, routine: Optional[str] = None
               ) -> List[Finding]:
    """CC001 over every rank's ``"hop"`` TransportRecords of one call: the
    i-th ring broadcast of each axis group is assembled from the i-th hop
    record of each of its ranks."""
    findings: List[Finding] = []
    groups: Dict[Tuple, Dict[int, List]] = {}
    for h in hops:
        if getattr(h, "kind", None) != "hop" or len(h.group) <= 1:
            continue
        groups.setdefault((h.axis, tuple(h.group)), {}).setdefault(
            h.rank, []).append(h)
    for (axis, members), by_rank in groups.items():
        counts = {r: len(v) for r, v in by_rank.items()}
        if set(by_rank) != set(members) or len(set(counts.values())) != 1:
            findings.append(make_finding(
                "CC001", f"ring over axis {axis!r} (ranks {list(members)}): "
                f"ranks disagree on the ring broadcasts they joined "
                f"({counts})", routine=routine))
            continue
        for i in range(next(iter(counts.values()))):
            links = {r: (v[i].send_to, v[i].recv_from)
                     for r, v in by_rank.items()}
            findings.extend(lint_ring(members, links, axis, routine=routine))
    return findings


# ------------------------- CC002 / CC003 / SH002 ----------------------------

def _planned_bytes(record) -> Optional[int]:
    """plan_pdgemm's collective term for one "pdgemm" schedule record."""
    info = record.info or {}
    try:
        from repro_torch.core.codesign import plan_pdgemm
        plan = plan_pdgemm(info["m"], info["n"], info["k"],
                           info["px"], info["py"],
                           dtype_bytes=info["itemsize"])
        return int(plan.collective_bytes)
    except Exception:
        return None


def lint_collective_records(records: Sequence, hops: Sequence = (),
                            counter_delta: Optional[Mapping[str, float]]
                            = None, routine: Optional[str] = None,
                            rank: Optional[int] = None) -> List[Finding]:
    """CC002 / CC003 / SH002 for one rank: its recorded schedule
    (``records``) against what its loops did (``hops``, its ``"hop"``
    TransportRecords) and its counter movement."""
    who = "" if rank is None else f"rank {rank}: "
    findings: List[Finding] = []
    rings = [r for r in records if getattr(r, "kind", None) == "ring_bcast"]
    scheds = [r for r in records if getattr(r, "kind", None) == "pdgemm"]
    pads = [r for r in records if getattr(r, "kind", None) == "pad_batch"]
    loops = [h for h in hops if getattr(h, "kind", None) == "hop"]

    for p in pads:
        info = p.info or {}
        batch = int(info.get("batch", 0))
        pad = int(info.get("pad", 0))
        ndev = int(p.size)
        if ndev > 0 and (batch + pad) % ndev != 0:
            findings.append(make_finding(
                "SH002", f"{who}batch {batch} padded by {pad} is not a "
                f"multiple of the {ndev}-rank mesh", routine=routine))
        elif pad >= ndev > 0:
            findings.append(make_finding(
                "SH002", f"{who}pad {pad} is not minimal for batch {batch} "
                f"over {ndev} ranks", routine=routine))
        if pad > 0 and not info.get("identity", False):
            findings.append(make_finding(
                "SH002", f"{who}batch pad of {pad} items is not identity "
                "filler - padded items are not safely factorizable",
                routine=routine))

    rec_hops = 0
    rec_by_axis: Dict[str, int] = {}
    for r in rings:
        want = max(int(r.size) - 1, 0)
        if int(r.hops) != want:
            findings.append(make_finding(
                "CC002", f"{who}ring_bcast over axis {r.axis!r} (size "
                f"{r.size}) recorded {r.hops} hops; a SUMMA ring step "
                f"must take exactly size - 1 = {want}", routine=routine))
        rec_hops += int(r.hops)
        key = str(r.axis) if r.axis is not None else ""
        rec_by_axis[key] = rec_by_axis.get(key, 0) + int(r.hops)
    did_by_axis: Dict[str, int] = {}
    for h in loops:
        did_by_axis[str(h.axis)] = did_by_axis.get(str(h.axis), 0) + h.hops
    for axis in sorted(set(rec_by_axis) | set(did_by_axis)):
        did, want = did_by_axis.get(axis, 0), rec_by_axis.get(axis, 0)
        if did != want:
            findings.append(make_finding(
                "CC002", f"{who}axis {axis!r}: the ring loops made {did} "
                f"hop(s) but the recorded schedule declares {want}",
                routine=routine))
    if counter_delta is not None and rec_hops != int(
            counter_delta.get("collective.hops", 0)):
        findings.append(make_finding(
            "CC002", f"{who}collective.hops counter moved "
            f"{counter_delta.get('collective.hops', 0)} but the recorded "
            f"schedule declares {rec_hops} hop(s)", routine=routine))

    tol = rules.drift_tolerance(rules.DRIFT_COMM_TOL, routine)
    sent = sum(h.bytes for h in loops)
    if counter_delta is not None and (rings or sent):
        c_bytes = int(counter_delta.get("collective.bytes", 0))
        if _drift(sent, c_bytes) > tol:
            findings.append(make_finding(
                "CC003", f"{who}bytes sent on the ring links {sent} vs "
                f"collective.bytes counter {c_bytes}: drift "
                f"{_drift(sent, c_bytes):.2f} > declared tolerance "
                f"{tol:.2f}", routine=routine))
    if scheds:
        planned = [_planned_bytes(r) for r in scheds]
        if None not in planned:
            total = sum(planned)
            if _drift(sent, total) > tol:
                findings.append(make_finding(
                    "CC003", f"{who}bytes sent on the ring links {sent} vs "
                    f"plan_pdgemm collective term {total}: drift "
                    f"{_drift(sent, total):.2f} > declared tolerance "
                    f"{tol:.2f}", routine=routine))
    return findings


# ------------------------------ SH001 / SH003 --------------------------------

def lint_partitions(transport: Sequence, routine: Optional[str] = None
                    ) -> List[Finding]:
    """SH001 over ``"partition"`` TransportRecords."""
    findings: List[Finding] = []
    for t in transport:
        if getattr(t, "kind", None) != "partition":
            continue
        info = t.info or {}
        mesh = info.get("mesh", {})
        padded, block = info.get("padded", []), info.get("block", [])
        what = (f"rank {t.rank}: {info.get('routine')} operand "
                f"{info.get('operand')!r}")
        sharded = {}
        for dim, axes in (info.get("spec") or {}).items():
            dim = int(dim)
            missing = [a for a in axes if a not in mesh]
            if missing:
                findings.append(make_finding(
                    "SH001", f"{what} names mesh axes {missing} absent from "
                    f"the mesh (axes={sorted(mesh)})", routine=routine))
                continue
            extent = 1
            for a in axes:
                extent *= mesh[a]
            if dim >= len(padded):
                findings.append(make_finding(
                    "SH001", f"{what} shards dim {dim} of a rank-"
                    f"{len(padded)} operand {tuple(padded)}",
                    routine=routine))
            elif extent > 0 and padded[dim] % extent != 0:
                findings.append(make_finding(
                    "SH001", f"{what}: dim {dim} ({padded[dim]}) not "
                    f"divisible by mesh axes {list(axes)} extent {extent} "
                    f"(shape {tuple(padded)})", routine=routine))
            else:
                sharded[dim] = extent
        want = [d // sharded.get(i, 1) for i, d in enumerate(padded)]
        if block and len(block) == len(padded) and list(block) != want:
            findings.append(make_finding(
                "SH001", f"{what} took a {tuple(block)} block of "
                f"{tuple(padded)}; its spec gives {tuple(want)}",
                routine=routine))
        if any(p < s for p, s in zip(padded, info.get("shape", []))):
            findings.append(make_finding(
                "SH001", f"{what} padded {tuple(info.get('shape', []))} "
                f"down to {tuple(padded)}", routine=routine))
    return findings


def lint_replication(transport: Sequence, routine: Optional[str] = None
                     ) -> List[Finding]:
    """SH003 over ``"all_gather"`` / ``"all_to_all"`` TransportRecords not
    tagged as a routine's result gather (first hit per rank and axis)."""
    findings: List[Finding] = []
    seen = set()
    for t in transport:
        if getattr(t, "kind", None) not in REPLICATING or t.tag == "result" \
                or len(t.group) <= 1:
            continue
        key = (t.rank, t.kind, t.axis)
        if key in seen:
            continue
        seen.add(key)
        findings.append(make_finding(
            "SH003", f"rank {t.rank}: {t.kind!r} over axis {t.axis!r} "
            f"inside the routine's body replicates a sharded operand "
            f"({t.bytes} B per shard) onto every rank of the axis",
            routine=routine))
    return findings


# ---------------------------------- all rules ---------------------------------

def lint_spmd(ranks: Sequence[Mapping], routine: Optional[str] = None
              ) -> List[Finding]:
    """All CC / SH rules for one call, from every rank's capture: each
    entry of ``ranks`` holds ``rank``, ``records`` (CollectiveRecords),
    ``transport`` (TransportRecords) and ``counter_delta``."""
    findings = lint_rings([t for r in ranks for t in r["transport"]],
                          routine=routine)
    for r in ranks:
        findings.extend(lint_collective_records(
            r["records"], r["transport"], r["counter_delta"],
            routine=routine, rank=r["rank"]))
        findings.extend(lint_partitions(r["transport"], routine=routine))
        findings.extend(lint_replication(r["transport"], routine=routine))
    return findings
