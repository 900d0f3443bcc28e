"""Frozen rule vocabulary, findings, and suppression for
repro_torch.analysis (port of ``repro.analysis.rules``, host code kept as
it is: the same 18 rules, ids, titles, severities and order, the same
findings, suppression and drift tolerances).

The rule IDs below are a *frozen public contract*: allowlists, doc
references, and seeded-violation tests all key on them, so an ID may gain
wording but never disappear or change severity silently. Three families mirror the
paper's static-structure claim (performance is predictable from the DAG):

* ``KL...`` kernel-launch rules - the Pallas launch geometry contract
  (block divisibility, VMEM budget, index dtypes, zero-dim routing),
* ``DF...`` dtype-flow rules - precision discipline in the traced jaxpr
  (no silent f64, accumulator widths, convert round-trips, host calls),
* ``CM...`` cost-model-drift rules - the hand-written ``flops``/``bytes``
  span annotations must keep agreeing with jaxpr-derived counts.

Suppression is structured, never a bare boolean: the ``allow()`` context
scopes rule IDs (optionally to one routine) for a ``with`` block, and an
allowlist JSON file pins per-call-site exemptions with a reason. Both
paths *record* the suppression on the report instead of dropping the
finding. Allowlist loading follows the registry convention
(``repro_torch.tune.registry``): a missing file is silently empty, a corrupt
file warns once per path and is treated as empty - a broken allowlist can
re-fire findings, never hide new ones.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import warnings
from collections import OrderedDict
from contextvars import ContextVar
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

ERROR = "error"
WARN = "warn"
INFO = "info"
SEVERITIES = (ERROR, WARN, INFO)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One frozen rule: stable ID, severity, and the invariant it checks."""

    id: str
    title: str
    severity: str
    description: str


RULES: "OrderedDict[str, Rule]" = OrderedDict((r.id, r) for r in (
    Rule("KL001", "kernel-block-geometry", ERROR,
         "Pallas block shapes must divide the padded operand dims they "
         "tile, and resolved GEMM-plan tiles must stay aligned to the "
         "machine's sublane - a non-dividing or misaligned block launches "
         "partial tiles the kernels were never written to mask."),
    Rule("KL002", "kernel-vmem-budget", ERROR,
         "The modeled VMEM working set of every Pallas launch "
         "(double-buffered operand blocks + scratch) and every resolved "
         "plan must fit MachineSpec.memory.vmem_bytes - the same veto "
         "FusedChainPlan.fits_vmem applies to fusion."),
    Rule("KL003", "kernel-index-dtype", ERROR,
         "Index/iota/grid arithmetic inside a Pallas kernel body must be "
         "int32 even under JAX_ENABLE_X64; a 64-bit index dtype is the "
         "exact class of the PR 8 trsm_gemm crash."),
    Rule("KL004", "kernel-zero-dim-routing", ERROR,
         "Zero-dim operands must route to the plain-jnp fallback: a "
         "Pallas launch (or a trace-time crash) on an empty operand is "
         "the PR 8 _gemm_exec bug class."),
    Rule("DF001", "dtype-silent-f64", ERROR,
         "Under an f32/bf16 ExecutionContext no traced intermediate may "
         "silently promote to float64 (checked with x64 enabled, where "
         "promotion is representable)."),
    Rule("DF002", "dtype-accum-width", ERROR,
         "float64 operands must keep float64 accumulators: a dot_general "
         "over f64 inputs may not emit a narrower output."),
    Rule("DF003", "dtype-convert-roundtrip", WARN,
         "A convert_element_type round-trip through a narrower dtype "
         "(A -> B -> A with B narrower) destroys precision invisibly."),
    Rule("DF004", "dtype-host-transfer", ERROR,
         "Traced routine bodies must stay on device: host callbacks "
         "(pure/io/debug callback) and device_put transfers do not belong "
         "in the jaxpr of a BLAS/LAPACK routine."),
    Rule("CM001", "cost-flops-drift", ERROR,
         "The flops a routine's span annotation declares must agree with "
         "the jaxpr_census-derived count within the routine's declared "
         "tolerance (per shape and dtype)."),
    Rule("CM002", "cost-bytes-drift", WARN,
         "The bytes a routine's span annotation declares must agree with "
         "the traced operand/result bytes within the routine's declared "
         "tolerance."),
    Rule("CM003", "cost-retrace-instability", WARN,
         "Tracing the same routine twice with identical shapes/dtypes "
         "must produce the same jaxpr - a drifting trace means an "
         "unstable jit cache key (retrace per call)."),
    Rule("CC001", "collective-ring-permutation", ERROR,
         "Every ppermute permutation must be a bijective single-cycle "
         "ring over its mesh axis: a self-send, duplicate endpoint, "
         "partial coverage, or multi-cycle perm deadlocks or drops "
         "panels at runtime instead of failing a test."),
    Rule("CC002", "collective-hop-count", ERROR,
         "Ring-broadcast hop accounting must match the traced schedule: "
         "every recorded ring_bcast performs exactly size - 1 ppermute "
         "hops on its axis, and the jaxpr hop census must equal the "
         "recorded and counter totals."),
    Rule("CC003", "collective-bytes-drift", ERROR,
         "Jaxpr-derived on-wire collective bytes must agree with the obs "
         "collective counters and with plan_pdgemm's collective term "
         "within the declared comm tolerance - the distributed sibling "
         "of CM001."),
    Rule("SH001", "shardmap-spec-shape", ERROR,
         "shard_map in/out specs must be consistent with operand shapes "
         "and the mesh: every named dim divisible by its mesh-axes "
         "extent, every referenced axis present on the mesh, no spec "
         "entry beyond the operand rank."),
    Rule("SH002", "shardmap-pad-discipline", ERROR,
         "Ragged batches sharded over a mesh must be identity-padded to "
         "a device-count multiple (minimal pad, invertible filler) - the "
         "lapack.distributed discipline that keeps every padded item "
         "factorizable."),
    Rule("SH003", "shardmap-replication", WARN,
         "No unintended replication of sharded operands: an all_gather / "
         "all_to_all inside a shard_map body materializes a sharded "
         "operand on every device, defeating the sharding its specs "
         "declared."),
    Rule("BY001", "dispatcher-bypass", ERROR,
         "Raw dot_general/conv contractions reachable from the model "
         "zoo, the hand-rolled attention/SSD kernels, or the serving "
         "path that never pass through tune.dispatch.resolve bypass the "
         "dispatcher; every such site must be on the committed burn-down "
         "allowlist (new sites fail CI)."),
))


# Cost-model drift tolerances, as a symmetric relative error
# |annotated - derived| / max(annotated, derived). The annotations are
# *leading-order paper coefficients* (see repro.linalg.blas /
# repro.linalg.lapack), while the census counts every traced op, so each
# routine declares how much lower-order structure its annotation ignores.
# These are declared bounds, not aspirations: the drift rules exist to
# catch *changes* that push a routine outside its band (an accidental
# O(n^4) update, a dropped term), exactly like tune.measure's
# model_residual bands the measured side.
DRIFT_FLOPS_TOL: Dict[str, float] = {
    # the GEMM-shaped ops trace within ~2% of their 2mnk annotations;
    # default covers them plus the level-1 ops whose bookkeeping the
    # 2n-style annotations ignore (measured <= 0.33 at lint shapes)
    "default": 0.45,
    # overflow-safe nrm2 does an extra abs/max/scale pass (measured 0.50)
    "nrm2": 0.65,
    # row-sequential triangular solves: the traced scan masks the full
    # vector per row, n^2-ish overhead on the n^2 annotation (0.76/0.52)
    "trsv": 0.85, "trsm": 0.70,
    # blocked factorizations: the masked right-looking implementations
    # trace full-matrix updates per step (~2n^3 traced volume against the
    # leading-order n^3/3-style coefficients; measured 0.67-0.93). The
    # band is tight in ratio terms: a complexity-class regression (an
    # accidental O(n^4) update) lands at drift > 0.98 and still fires.
    "cholesky": 0.90, "lu": 0.90, "qr": 0.80, "solve": 0.88, "lstsq": 0.96,
    "batched_cholesky": 0.90, "batched_lu": 0.90, "batched_qr": 0.90,
    "batched_solve": 0.82,
}
DRIFT_BYTES_TOL: Dict[str, float] = {
    # annotations price *operand* bytes; the traced boundary adds the
    # results, up to ~2x for the write-heavy ops (measured <= 0.51)
    "default": 0.60,
    # syrk annotates A only, the boundary carries the n x n product
    # (0.60); qr's boundary carries Q and R (0.67)
    "syrk": 0.72, "qr": 0.78, "batched_qr": 0.72,
}


DRIFT_COMM_TOL: Dict[str, float] = {
    # the three sides of CC003 (traced ppermute bytes, obs counters,
    # plan_pdgemm's collective term) agree *exactly* on the direct pdgemm
    # path today - measured drift 0.0 across meshes {(1,1),(2,2),(4,2)} x
    # {f32,bf16,f64}. The band is slack for rounding in future
    # overlap/2.5D schedules, not for today's code.
    "default": 0.02,
}


def drift_tolerance(table: Mapping[str, float], routine: Optional[str]) -> float:
    return table.get(routine or "", table["default"])


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit: what fired, where, and whether it was suppressed."""

    rule: str
    severity: str
    routine: Optional[str]
    message: str
    location: Optional[str] = None
    case: Optional[Mapping] = None      # {"policy","dtype","mesh",...}
    suppressed: bool = False
    suppressed_by: Optional[str] = None  # "allow()" | "allowlist:<path>"

    def to_json(self) -> Dict:
        d = {"rule": self.rule, "severity": self.severity,
             "routine": self.routine, "message": self.message,
             "location": self.location, "suppressed": self.suppressed}
        if self.case is not None:
            d["case"] = dict(self.case)
        if self.suppressed_by is not None:
            d["suppressed_by"] = self.suppressed_by
        return d


def make_finding(rule_id: str, message: str, routine: Optional[str] = None,
                 location: Optional[str] = None,
                 case: Optional[Mapping] = None) -> Finding:
    rule = RULES[rule_id]
    return Finding(rule=rule.id, severity=rule.severity, routine=routine,
                   message=message, location=location, case=case)


# ------------------------------- suppression --------------------------------

_ALLOW: "ContextVar[Tuple[Tuple[str, Optional[str]], ...]]" = ContextVar(
    "analysis_allow", default=())


@contextlib.contextmanager
def allow(*rule_ids: str, routine: Optional[str] = None):
    """Scope-suppress rule IDs (optionally for one routine only).

    Findings that match inside the block are still *recorded* - they land
    in ``AnalysisReport.suppressed`` with ``suppressed_by="allow()"`` -
    they just stop counting as failures. Unknown IDs raise immediately so
    a typo cannot silently allow nothing.
    """
    for rid in rule_ids:
        if rid not in RULES:
            raise KeyError(f"unknown rule id {rid!r}; known: "
                           f"{', '.join(RULES)}")
    frames = _ALLOW.get() + tuple((rid, routine) for rid in rule_ids)
    token = _ALLOW.set(frames)
    try:
        yield
    finally:
        _ALLOW.reset(token)


def _context_allows(finding: Finding) -> bool:
    for rid, routine in _ALLOW.get():
        if rid == finding.rule and (routine is None
                                    or routine == finding.routine):
            return True
    return False


_warned_paths: set = set()


@dataclasses.dataclass(frozen=True)
class Allowlist:
    """Parsed allowlist file: (rule, routine-or-None, reason) entries."""

    path: Optional[str] = None
    entries: Tuple[Tuple[str, Optional[str]], ...] = ()

    def matches(self, finding: Finding) -> bool:
        for rid, routine in self.entries:
            if rid == finding.rule and (routine is None
                                        or routine == finding.routine):
                return True
        return False


def load_allowlist(path: Optional[str]) -> Allowlist:
    """Load a JSON allowlist; registry-convention fallbacks.

    Format: ``{"schema_version": 1, "allow": [{"rule": "CM002",
    "routine": "qr", "reason": "..."}]}`` (``routine`` optional = any).
    Missing file -> silently empty (cold start). Corrupt / wrong-schema
    file -> ``RuntimeWarning`` once per path, treated as empty, so a bad
    allowlist re-fires its findings instead of hiding new ones.
    """
    if path is None or not os.path.exists(path):
        return Allowlist(path=path)
    try:
        with open(path) as f:
            raw = json.load(f)
        if int(raw.get("schema_version", -1)) != SCHEMA_VERSION:
            raise ValueError(f"schema_version {raw.get('schema_version')!r}"
                             f" != {SCHEMA_VERSION}")
        entries = []
        for e in raw["allow"]:
            rid = str(e["rule"])
            if rid not in RULES:
                raise ValueError(f"unknown rule id {rid!r}")
            entries.append((rid, e.get("routine")))
        return Allowlist(path=path, entries=tuple(entries))
    except Exception as exc:  # corrupt: warn once, never hide findings
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(f"analysis allowlist {path!r} is corrupt "
                          f"({exc}); treating as empty", RuntimeWarning,
                          stacklevel=2)
        return Allowlist(path=path)


def apply_suppression(findings: Sequence[Finding],
                      allowlist: Optional[Allowlist] = None
                      ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (active, suppressed), tagging the suppressor."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        if _context_allows(f):
            suppressed.append(dataclasses.replace(
                f, suppressed=True, suppressed_by="allow()"))
        elif allowlist is not None and allowlist.matches(f):
            suppressed.append(dataclasses.replace(
                f, suppressed=True,
                suppressed_by=f"allowlist:{allowlist.path}"))
        else:
            active.append(f)
    return active, suppressed
