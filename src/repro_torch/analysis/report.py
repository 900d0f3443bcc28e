"""analysis.check / check_surface / check_distributed: trace, lint, report
(port of ``repro.analysis.report``).

``check(fn, *args)`` runs ``fn`` once on fake tensors under ``make_fx``
(:func:`repro_torch.analysis.fake_card.trace`): nothing is computed and
nothing launches. The trace follows the active context's device: ``cuda``
(the default) traces the card route on fake CUDA tensors - every kernel
wrapper records the launch it would make, priced under ``h100`` - and needs
no card; ``linalg.use(device="cpu")`` traces the plain route. One trace,
two views:

* the aten graph, everything outside the kernels: dtype flow
  (:mod:`repro_torch.analysis.fx_lint`, DF001-DF004);
* the launch records and the dispatcher's resolutions: launch geometry
  (:mod:`repro_torch.analysis.kernel_lint`, KL001-KL004);
* cost-model drift: the routine's ``_routine`` annotation (``flops`` /
  ``bytes``) against the ``fx_census`` count of the ``policy="reference"``
  trace on the CPU plus the analytic flops of any LAPACK op it calls
  (CM001) and against the traced boundary bytes (CM002), and a second trace
  whose graph code must equal the first's (CM003).

The mesh has no trace: a mesh routine is one process per rank. So the mesh
legs of :func:`check_surface` and :func:`check_distributed` run the call
for real (SPMD: every rank of the world calls, with the same operands),
each rank recording its resolutions, launches, collective schedule,
transport and counter movement; rank 0 gathers them, runs the CC / SH
rules (:mod:`repro_torch.analysis.spmd_lint`) and the launch rules, and
broadcasts the report, so every rank returns it. A mesh that needs more
ranks than the process group has (or no process group) records a skipped
case, as the reference records one for missing devices.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import fake_card, kernel_lint, rules, spmd_lint
from repro_torch.analysis.fx_lint import iter_nodes, lint_dtype_flow, op_name
from repro_torch.analysis.rules import (Allowlist, Finding, apply_suppression,
                                        drift_tolerance, make_finding)

SCHEMA_VERSION = rules.SCHEMA_VERSION


@dataclasses.dataclass
class AnalysisReport:
    """Lint results for one target (routine or surface sweep).

    ``cases`` records what was actually checked - one dict per traced
    (policy, dtype, mesh) leg, including skips - so a report that found
    nothing is distinguishable from a report that checked nothing.
    """

    target: str
    cases: List[Dict]
    findings: List[Finding]
    suppressed: List[Finding]
    schema_version: int = SCHEMA_VERSION

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == rules.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == rules.WARN]

    @property
    def ok(self) -> bool:
        """No unsuppressed errors (warnings do not fail the gate)."""
        return not self.errors

    def to_json(self) -> Dict:
        return {"schema_version": self.schema_version, "target": self.target,
                "cases": self.cases,
                "findings": [f.to_json() for f in self.findings],
                "suppressed": [f.to_json() for f in self.suppressed]}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    def summary(self) -> str:
        n_e, n_w = len(self.errors), len(self.warnings)
        head = (f"analysis[{self.target}]: {len(self.cases)} case(s), "
                f"{n_e} error(s), {n_w} warning(s), "
                f"{len(self.suppressed)} suppressed")
        lines = [head]
        for f in self.findings:
            lines.append(f"  {f.severity.upper():5s} {f.rule} "
                         f"[{f.routine or '-'}] {f.message}")
        for f in self.suppressed:
            lines.append(f"  allow {f.rule} [{f.routine or '-'}] "
                         f"(via {f.suppressed_by})")
        return "\n".join(lines)


def merge_reports(reports: Sequence[AnalysisReport],
                  target: str) -> AnalysisReport:
    cases: List[Dict] = []
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for r in reports:
        cases.extend(r.cases)
        findings.extend(r.findings)
        suppressed.extend(r.suppressed)
    return AnalysisReport(target, cases, findings, suppressed)


# ------------------------------ tracing helpers -----------------------------

def _leaves(args, kw) -> list:
    out: list = []
    fake_card._leaves((args, kw), out)
    return out


def _has_zero_dim(args, kw) -> bool:
    return any(0 in tuple(getattr(a, "shape", ())) for a in _leaves(args, kw))


_ADDR = re.compile(r"0x[0-9a-fA-F]+")


def _normalize_graph_code(gm) -> str:
    """Graph code with memory addresses scrubbed: two traces of a stable
    function compare equal even where constants repr their objects."""
    return _ADDR.sub("0x", gm.code)


def _device() -> torch.device:
    """The active linalg context's device (``cuda`` unless a scope says)."""
    from repro_torch.linalg.context import current, resolved_device_name
    return resolved_device_name(current())


# --------------------------- cost-model drift (CM) --------------------------

def _getrf_flops(m, n):
    k = min(m, n)
    return m * n * k - (m + n) * k * k // 2 + k ** 3 // 3


def _geqrf_flops(m, n):
    k = min(m, n)
    return 2 * m * n * k - k * k * (m + n) + 2 * k ** 3 // 3


def _opaque_lapack_flops(gm) -> float:
    """Analytic flops of the aten LAPACK ops the census counts nothing for
    (``linalg_cholesky_ex``, ``linalg_lu`` / ``linalg_lu_factor_ex``,
    ``geqrf``, ``linalg_householder_product``, ``linalg_solve_triangular``
    / ``triangular_solve``): leading-order coefficients, the accounting of
    the span annotations (the reference's ``_opaque_lapack_flops`` on aten
    names)."""
    total = 0.0
    for node in iter_nodes(gm):
        name = op_name(node)
        vals = [a.meta.get("val") for a in node.args
                if isinstance(a, torch.fx.Node)]
        if not vals or not isinstance(vals[0], torch.Tensor):
            continue
        s = tuple(vals[0].shape)
        if len(s) < 2:
            continue
        batch = float(np.prod(s[:-2])) if len(s) > 2 else 1.0
        if name == "linalg_cholesky_ex":
            total += batch * s[-1] ** 3 / 3
        elif name in ("linalg_lu", "linalg_lu_factor_ex"):
            total += batch * _getrf_flops(s[-2], s[-1])
        elif name == "geqrf":
            total += batch * _geqrf_flops(s[-2], s[-1])
        elif name == "linalg_householder_product":
            k = min(s[-2], s[-1])
            total += batch * (4 * s[-2] * s[-1] * k - 2 * (s[-2] + s[-1])
                              * k * k + 4 * k ** 3 / 3) / 2
        elif name in ("linalg_solve_triangular", "triangular_solve") \
                and len(vals) >= 2:
            # solve_triangular(A, B); triangular_solve(B, A)
            a, b = (vals[0], vals[1]) if name != "triangular_solve" \
                else (vals[1], vals[0])
            nrhs = b.shape[-1] if b.ndim >= 2 else 1
            total += batch * a.shape[-1] ** 2 * nrhs
    return total


def _bytes(pairs) -> int:
    total = 0
    for shape, dtype in pairs:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * dtype.itemsize
    return total


def _boundary_bytes(tr: fake_card.Trace) -> int:
    """Bytes of the traced call's tensor inputs and outputs."""
    return _bytes(tr.inputs) + _bytes(tr.outputs)


def _rel_drift(annotated: float, derived: float) -> float:
    if annotated == derived:
        return 0.0
    return abs(annotated - derived) / max(abs(annotated), abs(derived), 1.0)


def _drift_findings(fn: Callable, args, kw, info: Callable,
                    tr: fake_card.Trace, routine: Optional[str],
                    case: Optional[Mapping]) -> List[Finding]:
    """CM001/CM002: span annotation vs graph-derived counts.

    The census runs on the ``policy="reference"`` trace on the CPU (plain
    PyTorch: the census cannot see inside a kernel), which is fair game -
    the annotation claims to price the mathematical routine, not one
    kernelization of it."""
    from repro_torch import linalg
    from repro_torch.core.fx_census import census_of_graph
    findings: List[Finding] = []
    try:
        ann = info(*args, **kw)
        ann_flops = float(ann["flops"])
        ann_bytes = float(ann["bytes"])
    except Exception as exc:
        findings.append(make_finding(
            "CM001", f"span annotation info fn failed: {exc!r}",
            routine=routine, case=case))
        return findings
    cpu = torch.device("cpu")
    with linalg.use(policy="reference", device="cpu"):
        ref = fake_card.trace(fn, args, kw, cpu, decompose=True)
    derived_flops = census_of_graph(ref.graph, routine or "fn").flops \
        + _opaque_lapack_flops(ref.graph)
    tol_f = drift_tolerance(rules.DRIFT_FLOPS_TOL, routine)
    drift_f = _rel_drift(ann_flops, derived_flops)
    if drift_f > tol_f:
        findings.append(make_finding(
            "CM001", f"flops annotation {ann_flops:.4g} vs census "
            f"{derived_flops:.4g}: drift {drift_f:.2f} > declared "
            f"tolerance {tol_f:.2f}", routine=routine, case=case))
    derived_bytes = _boundary_bytes(tr)
    tol_b = drift_tolerance(rules.DRIFT_BYTES_TOL, routine)
    drift_b = _rel_drift(ann_bytes, derived_bytes)
    if drift_b > tol_b:
        findings.append(make_finding(
            "CM002", f"bytes annotation {ann_bytes:.4g} vs traced "
            f"boundary {derived_bytes:.4g}: drift {drift_b:.2f} > "
            f"declared tolerance {tol_b:.2f}", routine=routine, case=case))
    return findings


# --------------------------------- check ------------------------------------

def _with_case(findings: List[Finding], case) -> List[Finding]:
    if case is None:
        return findings
    return [dataclasses.replace(f, case=dict(case)) if f.case is None else f
            for f in findings]


def check(fn: Callable, *args, routine: Optional[str] = None,
          info: Optional[Callable] = None, machine=None,
          allowlist: Optional[Allowlist] = None, accum_dtype=None,
          drift: bool = True, retrace: bool = True,
          case: Optional[Mapping] = None, **kw) -> AnalysisReport:
    """Statically verify one callable against the rule vocabulary.

    ``fn`` is traced on fake tensors on the active context's device, never
    executed. ``routine``/``info`` default to the ``_analysis_op`` /
    ``_analysis_info`` attributes the ``_routine`` decorator attaches to
    every public linalg routine (so ``check(linalg.gemm, a, b)`` just
    works); ``info=None`` skips the drift rules. ``machine`` (default: the
    ambient machine of the trace's device) prices the plan view; launch
    records are held to the card's own budget. ``allowlist`` and any active
    :func:`repro_torch.analysis.allow` scopes move matching findings into
    ``report.suppressed`` instead of deleting them.
    """
    from repro_torch import arch as _arch
    from repro_torch.linalg.context import UNSET, current, resolved_mesh
    routine = routine or getattr(fn, "_analysis_op", None) \
        or getattr(fn, "__name__", None)
    info = info if info is not None else getattr(fn, "_analysis_info", None)
    if current().mesh not in (UNSET, None):
        # a mesh has no trace: its ranks run the call (every rank calls
        # check) and rank 0 lints what they recorded
        return _spmd_case(routine or "fn", dict(case or {}, routine=routine),
                          resolved_mesh(current()),
                          lambda _: fn(*args, **kw), allowlist, machine,
                          zero_dim=_has_zero_dim(args, kw))
    device = _device()
    mach = _arch.resolve_machine(machine, device)
    zero_dim = _has_zero_dim(args, kw)
    findings: List[Finding] = []
    cases: List[Dict] = [dict(case or {}, routine=routine,
                              zero_dim=zero_dim)]
    try:
        tr = fake_card.trace(fn, args, kw, device)
    except Exception as exc:
        if zero_dim:
            # an empty operand crashed the kernel path at trace time
            # instead of routing to the plain version
            findings.append(make_finding(
                "KL004", f"trace crashed on zero-dim operands: "
                f"{type(exc).__name__}: {exc}", routine=routine, case=case))
            active, suppressed = apply_suppression(findings, allowlist)
            return AnalysisReport(routine or "fn", cases, active, suppressed)
        raise
    findings.extend(kernel_lint.lint_kernel_launches(
        tr.launches, routine=routine, zero_dim_inputs=zero_dim))
    findings.extend(kernel_lint.lint_resolutions(
        tr.resolutions, mach, routine=routine))
    findings.extend(lint_dtype_flow(tr.graph, routine=routine,
                                    accum_dtype=accum_dtype,
                                    host_reads=tr.host_reads))
    if retrace:
        tr2 = fake_card.trace(fn, args, kw, device)
        if _normalize_graph_code(tr.graph) != \
                _normalize_graph_code(tr2.graph):
            findings.append(make_finding(
                "CM003", "two same-shape traces produced different graphs "
                "(an unstable trace - every call takes another path)",
                routine=routine, case=case))
    if drift and info is not None and not zero_dim:
        findings.extend(_drift_findings(fn, args, kw, info, tr, routine,
                                        case))
    active, suppressed = apply_suppression(_with_case(findings, case),
                                           allowlist)
    return AnalysisReport(routine or "fn", cases, active, suppressed)


def check_routine(name: str, *args, **kw) -> AnalysisReport:
    """``check`` a public routine by its ``repro_torch.linalg`` name."""
    from repro_torch import linalg
    return check(getattr(linalg, name), *args, **kw)


# ------------------------------ the mesh (SPMD) ------------------------------

def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 0


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _world() else 0


def _broadcast(obj):
    """``obj`` of rank 0 on every rank of the world (as it is without a
    process group)."""
    if not _world():
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _spmd_capture(call: Optional[Callable]) -> Optional[List[Dict]]:
    """Run ``call`` on this rank (None: a rank outside the mesh, which only
    joins the gather) with every record scope open; returns every rank's
    capture on rank 0, None elsewhere."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import (record_collectives,
                                                     record_transport)
    from repro_torch.kernels.launch_record import record_launches
    from repro_torch.obs import counters as _counters
    from repro_torch.tune.dispatch import record_resolutions
    before = _counters.snapshot()
    error = None
    with record_resolutions() as res, record_launches() as launches, \
            record_collectives() as coll, record_transport() as tr:
        if call is not None:
            try:
                call()
            except Exception as exc:
                error = f"{type(exc).__name__}: {exc}"
    mine = {"rank": dist.get_rank(), "member": call is not None,
            "records": list(coll), "transport": list(tr),
            "counter_delta": _counters.delta(before),
            "launches": list(launches), "resolutions": list(res),
            "error": error}
    world = dist.get_world_size()
    out = [None] * world if dist.get_rank() == 0 else None
    dist.gather_object(mine, out, dst=0)
    return out


def _dedupe(findings: List[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.message, f.location)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _spmd_findings(captures: List[Dict], routine: str, machine,
                   zero_dim: bool = False) -> List[Finding]:
    """Rank 0's lint of every member rank's capture of one call."""
    members = [c for c in captures if c["member"]]
    findings: List[Finding] = []
    for c in members:
        findings.extend(kernel_lint.lint_kernel_launches(
            c["launches"], routine=routine, zero_dim_inputs=zero_dim))
        if c["resolutions"]:
            from repro_torch import arch as _arch
            mach = _arch.resolve_machine(
                machine if machine is not None
                else c["resolutions"][0].machine)
            findings.extend(kernel_lint.lint_resolutions(
                c["resolutions"], mach, routine=routine))
    findings.extend(spmd_lint.lint_spmd(members, routine=routine))
    return _dedupe(findings)


def _spmd_case(name: str, case: Dict, mesh_obj, call: Callable, allowlist,
               machine, zero_dim: bool = False) -> AnalysisReport:
    """One mesh case, SPMD (every rank of the world calls, after every rank
    made ``mesh_obj``): the mesh's ranks run ``call(mesh_obj)``, rank 0
    lints the gathered captures and every rank returns its report (or
    raises, on every rank, if a rank's call failed)."""
    member = mesh_obj.get_coordinate() is not None
    captures = _spmd_capture((lambda: call(mesh_obj)) if member else None)
    out = None
    if _rank() == 0:
        failed = [(c["rank"], c["error"]) for c in captures
                  if c["error"] is not None]
        if failed:
            out = f"{name} {case} failed on rank(s): {failed}"
        else:
            findings = _with_case(
                _spmd_findings(captures, name, machine, zero_dim), case)
            active, suppressed = apply_suppression(findings, allowlist)
            out = AnalysisReport(name, [dict(case, ranks=len(
                [c for c in captures if c["member"]]))], active, suppressed)
    out = _broadcast(out)
    if isinstance(out, str):
        raise RuntimeError(out)
    return out


def _needs(leg) -> Optional[str]:
    """Why a mesh leg is skipped here, or None."""
    n = int(leg[0]) * int(leg[1])
    world = _world()
    if world < n:
        return f"needs {n} ranks" + ("" if world else " (no process group)")
    return None


# ----------------------------- surface sweep --------------------------------

# canonical operand sizes: big enough that blocked drivers take their
# real panel/trailing structure and leading-order flop terms dominate,
# small enough that a full sweep stays trace-only cheap
_N, _M, _K, _VEC, _BATCH = 64, 48, 32, 4096, 2


def _rng():
    return np.random.default_rng(0)


def _mat(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _spd(r, n):
    g = _mat(r, n, n)
    return (g @ g.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _surface_args(name: str) -> Optional[Tuple[tuple, dict]]:
    """Canonical (args, kwargs) for one linalg routine, float32 base (the
    reference's, draw for draw)."""
    r = _rng()
    n, m, k, v, bt = _N, _M, _K, _VEC, _BATCH
    if name == "gemm":
        return (_mat(r, m, k), _mat(r, k, n)), {}
    if name == "gemm_bias_act":
        return (_mat(r, m, k), _mat(r, k, n)), {"bias": _mat(r, n),
                                                "epilogue": "relu"}
    if name == "syrk":
        return (_mat(r, m, k),), {}
    if name == "trsm":
        t = np.tril(_mat(r, n, n)) + n * np.eye(n, dtype=np.float32)
        return (t.astype(np.float32), _mat(r, n, k)), {}
    if name == "gemv":
        return (_mat(r, m, k), _mat(r, k)), {}
    if name == "ger":
        return (1.5, _mat(r, m), _mat(r, k), _mat(r, m, k)), {}
    if name == "trsv":
        t = np.tril(_mat(r, n, n)) + n * np.eye(n, dtype=np.float32)
        return (t.astype(np.float32), _mat(r, n)), {}
    if name in ("axpy", "scal"):
        return ((1.5, _mat(r, v), _mat(r, v)) if name == "axpy"
                else (1.5, _mat(r, v))), {}
    if name in ("dot", "nrm2", "asum", "iamax"):
        return ((_mat(r, v), _mat(r, v)) if name == "dot"
                else (_mat(r, v),)), {}
    if name == "rot":
        return (_mat(r, v), _mat(r, v), 0.8, 0.6), {}
    if name == "cholesky":
        return (_spd(r, n),), {}
    if name in ("lu", "qr"):
        return (_mat(r, n, n),), {}
    if name == "solve":
        return (_spd(r, n), _mat(r, n, 4)), {}
    if name == "lstsq":
        return (_mat(r, n, k), _mat(r, n)), {}
    if name == "batched_cholesky":
        return (np.stack([_spd(r, k) for _ in range(bt)]),), {}
    if name in ("batched_lu", "batched_qr"):
        return (np.stack([_mat(r, k, k) for _ in range(bt)]),), {}
    if name == "batched_solve":
        from repro_torch.lapack.batched import FactorizationResult
        factors = np.stack([_spd(r, k) for _ in range(bt)])
        res = FactorizationResult(factors=torch.from_numpy(factors),
                                  pivots=None, tau=None, kind="potrf",
                                  block=16)
        return (res, _mat(r, bt, k)), {}
    return None                         # context machinery etc: not callable


def _cast_args(args, kw, dtype: torch.dtype, device=None):
    """Floating operands as ``dtype`` tensors (on ``device``, default the
    CPU: a trace makes its own fake copies)."""
    def cast(x):
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor) and x.dtype.is_floating_point:
            return x.to(dtype=dtype, device=device or "cpu")
        if isinstance(x, torch.Tensor):
            return x.to(device or "cpu")
        return x
    flat: list = []
    rebuild = fake_card._leaves((args, kw), flat)
    return rebuild([cast(x) for x in flat])


SURFACE_POLICIES = ("reference", "model", "tuned")
SURFACE_DTYPES = ("float32", "bfloat16", "float64")
SURFACE_MESH = (2, 2)
# the acceptance meshes: degenerate, square, and rectangular - the shapes
# that exercise distinct SUMMA schedules (0, 8, and 32 hops per pdgemm)
SURFACE_MESHES = ((1, 1), (2, 2), (4, 2))
# distributed entry points checked directly (not via the linalg context)
DISTRIBUTED_ROUTINES = ("pdgemm", "pdtrsm")


def _distributed_args(name: str) -> Tuple[tuple, dict]:
    """Canonical float32 operands for one direct distributed entry."""
    r = _rng()
    if name == "pdgemm":
        return (_mat(r, _M, _K), _mat(r, _K, _N)), {}
    if name == "pdtrsm":
        t = np.tril(_mat(r, _N, _N)) + _N * np.eye(_N, dtype=np.float32)
        return (t.astype(np.float32), _mat(r, _N, _K)), {}
    raise KeyError(name)


def check_distributed(meshes: Sequence[Tuple[int, int]] = SURFACE_MESHES,
                      policies: Sequence[str] = SURFACE_POLICIES,
                      dtypes: Sequence[str] = SURFACE_DTYPES,
                      allowlist: Optional[Allowlist] = None,
                      machine=None, progress: Optional[Callable] = None
                      ) -> AnalysisReport:
    """Sweep the direct ``pdgemm`` / ``pdtrsm`` entry points, SPMD.

    Every rank of the process group calls it; each mesh is made over the
    first ``px * py`` ranks (every rank makes it, its ranks call), on the
    active linalg context's device. Each case runs for real with every
    record scope open, and rank 0 lints what every rank recorded: the
    SUMMA schedule (ring links, hops, bytes, ``plan_pdgemm``'s collective
    term), partitions and gathers for the CC / SH rules, and the launches
    and plans for the KL rules. Every rank returns rank 0's report. Meshes
    needing more ranks than the group has record skipped cases.
    """
    from repro_torch.blas import distributed as _dist
    from repro_torch.linalg.context import current, resolved_device
    reports: List[AnalysisReport] = []
    for mesh in meshes:
        px, py = int(mesh[0]), int(mesh[1])
        skip = _needs(mesh)
        for name in DISTRIBUTED_ROUTINES:
            base = _distributed_args(name)
            fn = getattr(_dist, name)
            for dtype in dtypes:
                for policy in policies:
                    case = {"routine": name, "policy": policy,
                            "dtype": dtype, "mesh": [px, py],
                            "entry": "direct"}
                    if skip:
                        reports.append(AnalysisReport(
                            name, [dict(case, skipped=skip)], [], []))
                        continue
                    if progress is not None and _rank() == 0:
                        progress(case)
                    dev = resolved_device(current())
                    args, kw = _cast_args(*base, getattr(torch, dtype), dev)

                    def call(mesh_obj, fn=fn, args=args, kw=kw,
                             policy=policy):
                        return fn(*args, mesh=mesh_obj, policy=policy, **kw)
                    reports.append(_spmd_case(
                        name, case, _leg_mesh((px, py)), call, allowlist,
                        machine))
    return _broadcast(merge_reports(reports, target="distributed-surface"))


def surface_routines() -> List[str]:
    """The checkable (callable, arg-synthesizable) slice of linalg.__all__."""
    from repro_torch import linalg
    return [n for n in linalg.__all__ if _surface_args(n) is not None]


def check_surface(routines: Optional[Sequence[str]] = None,
                  policies: Sequence[str] = SURFACE_POLICIES,
                  dtypes: Sequence[str] = SURFACE_DTYPES,
                  mesh: Optional[Tuple[int, int]] = SURFACE_MESH,
                  allowlist: Optional[Allowlist] = None,
                  machine=None, progress: Optional[Callable] = None,
                  meshes: Optional[Sequence[Tuple[int, int]]] = None,
                  base_leg: bool = True,
                  distributed: Optional[bool] = None) -> AnalysisReport:
    """Sweep the public surface over the acceptance grid and merge.

    Grid: routines x policies x dtypes x {no mesh, meshes}, plus (for a
    full default sweep) the direct distributed entry points of
    :func:`check_distributed`. ``mesh`` is the legacy single-mesh knob:
    left at its default it expands to ``SURFACE_MESHES``; set explicitly
    it pins exactly that mesh (``None`` = no mesh legs). ``meshes``
    overrides both. The no-mesh legs are fake traces on the active
    context's device (``cuda``: the card route); under a process group
    rank 0 traces them and the others wait. A mesh leg runs SPMD (every
    rank calls ``check_surface``) and needs ``px * py`` ranks; it records a
    skipped case when the group has fewer. ``base_leg=False`` drops the
    no-mesh legs (the SPMD-only sweep); ``distributed`` defaults to True
    exactly for unrestricted default-grid sweeps. Drift and retrace probes
    run on the no-mesh legs only.
    """
    from repro_torch import linalg
    from repro_torch.linalg.context import current, resolved_device
    names = list(routines) if routines is not None else surface_routines()
    if meshes is None:
        if mesh is None:
            meshes = ()
        elif tuple(mesh) == SURFACE_MESH:
            meshes = SURFACE_MESHES
        else:
            meshes = (tuple(mesh),)
    meshes = tuple(tuple(m) for m in meshes)
    if distributed is None:
        distributed = routines is None and bool(meshes)
    reports: List[AnalysisReport] = []
    for name in names:
        base = _surface_args(name)
        if base is None:
            raise KeyError(f"no canonical surface args for {name!r}")
        fn = getattr(linalg, name)
        for dtype in dtypes:
            args, kw = _cast_args(*base, getattr(torch, dtype))
            for policy in policies:
                legs = ([None] if base_leg else []) + list(meshes)
                for leg in legs:
                    case = {"routine": name, "policy": policy,
                            "dtype": dtype,
                            "mesh": None if leg is None else list(leg)}
                    if leg is None:
                        if _rank() != 0:
                            continue
                        if progress is not None:
                            progress(case)
                        with linalg.use(policy=policy):
                            reports.append(check(
                                fn, *args, machine=machine,
                                allowlist=allowlist,
                                drift=policy == "reference",
                                retrace=True, case=case, **kw))
                        continue
                    skip = _needs(leg)
                    if skip:
                        reports.append(AnalysisReport(
                            name, [dict(case, skipped=skip)], [], []))
                        continue
                    if progress is not None and _rank() == 0:
                        progress(case)
                    dev = resolved_device(current())
                    largs, lkw = _cast_args(args, kw, getattr(torch, dtype),
                                            dev)

                    def call(mesh_obj, fn=fn, a=largs, k=lkw, policy=policy):
                        with linalg.use(policy=policy, mesh=mesh_obj):
                            return fn(*a, **k)
                    reports.append(_spmd_case(
                        name, case, _leg_mesh(leg), call, allowlist,
                        machine, zero_dim=_has_zero_dim(largs, lkw)))
    if distributed and meshes:
        reports.append(check_distributed(
            meshes=meshes, policies=policies, dtypes=dtypes,
            allowlist=allowlist, machine=machine, progress=progress))
    return _broadcast(merge_reports(reports, target="linalg-surface"))


_meshes: Dict[Tuple, object] = {}


def _leg_mesh(leg):
    """A mesh leg's ``("x", "y")`` mesh, made once per process group (every
    rank of the world calls it: the sub-groups are made collectively)."""
    import torch.distributed as dist

    from repro_torch.blas.distributed import make_blas_mesh
    key = (int(leg[0]), int(leg[1]), dist.group.WORLD)
    if key not in _meshes:
        _meshes[key] = make_blas_mesh(key[0], key[1])
    return _meshes[key]
