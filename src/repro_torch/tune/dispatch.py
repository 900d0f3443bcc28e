"""Unified BLAS/LAPACK kernel-config resolution and execution.

Port of ``repro.tune.dispatch``. ``resolve`` turns an (op, shape, dtype,
backend, policy) tuple into an executable config; ``dispatch`` executes
it. Every BLAS-3 and blocked-LAPACK call of the port funnels through here.

    policy      registry hit        registry miss / no file / corrupt
    ---------   -----------------   ---------------------------------
    reference   (never consulted)   plain PyTorch
    model       (never consulted)   plan_gemm / plan_trsm config
    tuned       stored config       model config  (source="fallback-model")

The plans are priced for the ambient machine of the call's device
(:func:`repro_torch.arch.current_machine`: ``"h100"`` on the card,
``"tpu-like"`` on the CPU, unless a scope or ``machine=`` names another),
and B1 / B3 launch the CTA tile of the resolved plan
(:func:`repro_torch.kernels.gemm.launch_tile`). The backend component of
registry keys is the operands' device type: ``"cuda"`` on the card,
``"cpu"`` on the CPU; the machine component follows the device's rule
(:func:`repro_torch.arch.machine_key_component`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import List, Optional, Tuple

import torch

from repro_torch import _dtype
from repro_torch import arch as _arch
from repro_torch import obs as _obs
from repro_torch.arch import MachineSpec
from repro_torch.core.codesign import (FusedChainPlan, GemmPlan,
                                       plan_from_blocks, plan_fused_chain,
                                       plan_gemm, plan_pdgemm, plan_trsm)
from repro_torch.kernels import fused as _fk
from repro_torch.kernels import gemm as _gk
from repro_torch.obs import counters as _counters
from repro_torch.tune.policy import resolve_policy, uses_kernel
from repro_torch.tune.registry import Registry, default_registry

OPS = ("gemm", "gemv", "trsm", "syrk", "pdgemm", "gemm+epilogue",
       "trsm+gemm")
FUSED_OPS = ("gemm+epilogue", "trsm+gemm")

# Resolution provenance for the dispatcher-bypass lint (BY001,
# repro_torch.analysis.bypass_lint): every product whose innermost
# repro_torch frame lies under one of these prefixes reached ``resolve()`` /
# ``dispatch()`` by construction - the BLAS/LAPACK drivers and the kernels
# this module launches are the governed set. A raw mm/bmm/addmm/baddbmm or
# convolution anywhere else (models/, launch/, B5 and B6) bypassed the
# dispatcher and must be on the committed burn-down allowlist.
DISPATCHED_MODULES = (
    "repro_torch/blas/", "repro_torch/lapack/", "repro_torch/linalg/",
    "repro_torch/tune/", "repro_torch/core/",
    "repro_torch/kernels/ops.py", "repro_torch/kernels/ref.py",
    "repro_torch/kernels/gemm.py", "repro_torch/kernels/fused.py",
    "repro_torch/kernels/dotp.py",
)


@dataclasses.dataclass(frozen=True)
class Resolution:
    """The resolved execution recipe for one call (the reference's fields;
    ``use_pallas`` keeps its name and means "runs the kernel")."""

    op: str
    policy: str                   # "reference" | "model" | "tuned"
    source: str                   # "reference" | "model" | "registry" |
                                  # "fallback-model"
    use_pallas: bool
    gemm_plan: Optional[GemmPlan] = None
    block: Optional[int] = None   # trsm diagonal width
    mesh: Optional[str] = None    # registry mesh component (distributed)
    machine: Optional[str] = None   # machine the call resolved under
    fused: bool = False           # run the streaming fused kernel?
    chain: Optional[FusedChainPlan] = None   # fused-vs-staged pricing

    def describe(self) -> dict:
        """JSON-able summary of the resolution."""
        d = {"op": self.op, "policy": self.policy, "source": self.source,
             "use_pallas": self.use_pallas, "machine": self.machine}
        if self.gemm_plan is not None:
            d["config"] = {"bm": self.gemm_plan.bm, "bn": self.gemm_plan.bn,
                           "bk": self.gemm_plan.bk}
        if self.block is not None:
            d.setdefault("config", {})["block"] = self.block
        if self.mesh is not None:
            d["mesh"] = self.mesh
        if self.op in FUSED_OPS:
            d["fused"] = self.fused
            if self.chain is not None:
                d["hbm_bytes_saved"] = self.chain.hbm_bytes_saved
        return d


# scoped Resolution capture for the static analyzer: every plan a call
# resolves inside the scope is recorded (repro_torch.analysis.kernel_lint
# checks them against the ambient machine's budget)
_RECORD: "ContextVar[Optional[List[Resolution]]]" = ContextVar(
    "repro_torch_dispatch_resolution_record", default=None)


@contextlib.contextmanager
def record_resolutions():
    """Collect every Resolution produced inside the scope."""
    rec: List[Resolution] = []
    token = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(token)


def _observed(res: Resolution) -> Resolution:
    """The scope's record, counters always; a ``tune.resolve`` provenance
    event when a trace is capturing."""
    rec = _RECORD.get()
    if rec is not None:
        rec.append(res)
    _counters.inc("dispatch.resolve")
    if res.policy == "tuned":
        _counters.inc("dispatch.registry_hit" if res.source == "registry"
                      else "dispatch.registry_miss")
    if _obs.enabled():
        _obs.event("tune.resolve", cat="resolve", **res.describe())
    return res


def default_backend() -> str:
    """Registry backend component when the caller names none."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve(op: str, shape: Tuple[int, ...], dtype,
            policy: Optional[str] = None,
            registry: Optional[Registry] = None,
            backend: Optional[str] = None,
            mesh: Optional[Tuple[int, int]] = None,
            machine: Optional[MachineSpec] = None,
            epilogue: str = "none", form: str = "lu",
            has_bias: bool = True) -> Resolution:
    """Resolve one call's config. shape is (m, n, k) for gemm/syrk/pdgemm
    (pdgemm: the *global* problem) and the fused chains, (m, n) for gemv,
    (n, nrhs) for trsm; ``backend`` is the device type the call runs on
    (default: ``"cuda"`` when a card is present); ``mesh`` is pdgemm's
    (px, py), whose registry entries live under the mesh-suffixed key
    ``pdgemm|bucket|dtype|backend|xPXyPY`` and whose plan tiles the
    per-step local update (:func:`plan_pdgemm`); ``machine`` (None = the
    ambient machine of that device, ``Resolution.machine`` names it)
    parameterizes every planner and, when it is not the device's own
    machine, suffixes the registry key."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    if op == "pdgemm" and mesh is None:
        raise ValueError("pdgemm resolution needs mesh=(px, py)")
    backend = backend or default_backend()
    mach = _arch.resolve_machine(machine, backend)
    mach_str = _arch.machine_key_component(mach, backend)
    mesh_str = f"x{mesh[0]}y{mesh[1]}" if op == "pdgemm" else None
    pol = resolve_policy(policy)
    if not uses_kernel(pol):
        # the reference trsm still needs a diagonal width: 64, the
        # reference's historical default
        return _observed(Resolution(op, pol, "reference", False,
                                    block=64 if op == "trsm" else None,
                                    mesh=mesh_str, machine=mach.name))
    db = _dtype.itemsize(dtype)
    cfg = None
    source = "model"
    if pol == "tuned":
        reg = registry if registry is not None else default_registry()
        # syrk and gemv execute as GEMMs and share the gemm entries (gemv
        # under its execution shape (m, 1, n))
        lookup_op, lookup_shape = op, shape
        if op == "syrk":
            lookup_op = "gemm"
        elif op == "gemv":
            lookup_op, lookup_shape = "gemm", (shape[0], 1, shape[1])
        cfg = reg.lookup(lookup_op, lookup_shape, dtype, backend,
                         mesh=mesh_str, machine=mach_str)
        source = "registry" if cfg is not None else "fallback-model"
    if op == "pdgemm":
        # the stored / planned config tiles the per-step local update
        # (m/px, k_fine) @ (k_fine, n/py)
        m, n, k = shape
        px, py = mesh
        pplan = plan_pdgemm(m, n, k, px, py, dtype_bytes=db, machine=mach)
        local = pplan.local if cfg is None else plan_from_blocks(
            -(-max(m, 1) // px), -(-max(n, 1) // py), pplan.k_fine,
            cfg.params["bm"], cfg.params["bn"], cfg.params["bk"],
            dtype_bytes=db, machine=mach)
        return _observed(Resolution(op, pol, source, True, gemm_plan=local,
                                    mesh=mesh_str, machine=mach.name))
    if op == "trsm":
        n, nrhs = shape
        block = cfg.params["block"] if cfg is not None \
            else plan_trsm(n, nrhs, dtype_bytes=db, machine=mach).block
        return _observed(Resolution(op, pol, source, True, block=block,
                                    machine=mach.name))
    m, n, k = (shape[0], 1, shape[1]) if op == "gemv" else shape
    plan = None if cfg is None else plan_from_blocks(
        m, n, k, cfg.params["bm"], cfg.params["bn"], cfg.params["bk"],
        dtype_bytes=db, machine=mach)
    if op in FUSED_OPS:
        chain = plan_fused_chain(op, m, n, k, dtype_bytes=db,
                                 epilogue=epilogue, form=form,
                                 has_bias=has_bias, machine=mach)
        # a registry hit stores the measured winner; the machine's scratch
        # budget still vetoes it
        fused = (bool(cfg.params.get("fused", 1)) and chain.fits_vmem) \
            if cfg is not None else chain.fused_wins
        return _observed(Resolution(op, pol, source, True,
                                    gemm_plan=plan or chain.gemm,
                                    block=chain.block, machine=mach.name,
                                    fused=fused, chain=chain))
    if plan is None:
        plan = plan_gemm(m, n, k, dtype_bytes=db, machine=mach)
    return _observed(Resolution(op, pol, source, True, gemm_plan=plan,
                                machine=mach.name))


def _gemm_exec(a: torch.Tensor, b: torch.Tensor, res: Resolution) -> torch.Tensor:
    if not res.use_pallas or 0 in a.shape or 0 in b.shape:
        # degenerate operands (e.g. a wide-LU trailing block with no rows
        # left) launch nothing; the plain product handles empties
        return a @ b
    _counters.inc("kernel.launch")
    if a.ndim == 2 and b.ndim == 1:                 # matvec as an (n, 1) GEMM
        return _gk.gemm(a, b[:, None], plan=res.gemm_plan)[:, 0]
    return _gk.gemm(a, b, plan=res.gemm_plan)


def dispatch(op: str, *args, policy: Optional[str] = None,
             registry: Optional[Registry] = None,
             machine: Optional[MachineSpec] = None, **kw):
    """One entry point for every BLAS-3 / blocked-LAPACK kernel call.

    dispatch("gemm", a, b)             -> a @ b (by policy)
    dispatch("syrk", a, trans=False)   -> a a^T / a^T a (by policy)
    dispatch("gemv", a, x, trans=...)  -> op(a) x (by policy)
    dispatch("trsm", a, b, lower=..., unit_diag=..., left=..., block=...)
    dispatch("pdgemm", a, b, mesh=..., c=..., alpha=..., beta=...)
                                       -> SUMMA on the mesh (every rank
                                          calls it)
    dispatch("gemm+epilogue", a, b, bias=..., epilogue=...)
                                       -> act(a @ b + bias); one fused
                                          launch when the chain plan says
                                          fusing wins
    dispatch("trsm+gemm", l11, ap, bl, c, form=..., unit_diag=..., fuse=...)
                                       -> (x, c - bl x) / (x, c - x^T x);
                                          fuse=None defers to the chain
                                          plan, True/False forces

    The registry backend is the operands' device type. An explicit
    ``machine`` scopes the whole call; ``None`` uses the ambient machine.
    Every op but ``"pdgemm"`` also takes a batch, operands with a leading
    (B,) axis: ``"gemm"`` and ``"gemm+epilogue"`` with either side 2-D
    and broadcast (``bias`` one length-n vector for every item),
    ``"syrk"`` a (B, n, k) A, ``"gemv"`` a (B, m, n) A with x (B, n) or a
    shared (n,), ``"trsm"`` and ``"trsm+gemm"`` every operand. They
    resolve on one item's shape, as the reference resolves inside
    ``vmap``, and run each GEMM-shaped step in one launch for the batch.
    """
    if machine is not None:
        with _arch.machine_scope(machine):
            return dispatch(op, *args, policy=policy, registry=registry, **kw)
    backend = args[0].device.type
    if op == "gemm":
        a, b = args
        n_out = 1 if a.ndim == 2 and b.ndim == 1 else b.shape[-1]
        res = resolve("gemm", (a.shape[-2], n_out, a.shape[-1]), a.dtype,
                      policy, registry, backend)
        return _gemm_exec(a, b, res)
    if op == "syrk":
        (a,) = args
        op_a = a.mT if kw.pop("trans", False) else a
        n, k = op_a.shape[-2:]
        res = resolve("syrk", (n, n, k), a.dtype, policy, registry, backend)
        return _gemm_exec(op_a, op_a.mT, res)
    if op == "gemv":
        a, x = args
        op_a = a.mT if kw.pop("trans", False) else a
        res = resolve("gemv", tuple(op_a.shape[-2:]), a.dtype, policy,
                      registry, backend)
        if not res.use_pallas:
            return op_a @ x if x.ndim == 1 else (op_a @ x[..., None])[..., 0]
        return _gemm_exec(op_a, x[..., None], res)[..., 0]
    if op == "trsm":
        a, b = args
        from repro_torch.blas import level3         # lazy: avoid import cycle
        return level3.trsm(a, b, policy=policy, registry=registry, **kw)
    if op == "pdgemm":
        a, b = args
        from repro_torch.blas import distributed    # lazy: avoid import cycle
        return distributed.pdgemm(a, b, policy=policy, registry=registry,
                                  **kw)
    if op == "gemm+epilogue":
        a, b = args
        bias = kw.pop("bias", None)
        epilogue = kw.pop("epilogue", "none")
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        res = resolve("gemm+epilogue", (m, n, k), a.dtype, policy, registry,
                      backend, epilogue=epilogue, has_bias=bias is not None)
        if not res.use_pallas:
            return _fk.apply_epilogue(a @ b, epilogue, bias)
        _counters.inc("kernel.launch")
        if res.fused:
            items = _gk.batch_of(a, b) or 1
            with _fk.fused_span("gemm_bias_act", res.chain,
                                epilogue=epilogue,
                                flops=items * 2 * m * n * k,
                                bytes=items * res.chain.fused_hbm_bytes):
                return _fk.gemm_bias_act(a, b, bias=bias, epilogue=epilogue,
                                         plan=res.gemm_plan)
        # staged: the GEMM kernel, then the epilogue as a second pass over
        # the product in device memory
        return _fk.apply_epilogue(_gk.gemm(a, b, plan=res.gemm_plan),
                                  epilogue, bias)
    if op == "trsm+gemm":
        l11, a_panel, b_left, c = args
        form = kw.pop("form", "lu")
        unit_diag = kw.pop("unit_diag", False)
        fuse = kw.pop("fuse", None)
        m, n, nb = c.shape[-2], c.shape[-1], l11.shape[-1]
        res = resolve("trsm+gemm", (m, n, nb), c.dtype, policy, registry,
                      backend, form=form)
        do_fuse = res.fused if fuse is None \
            else (bool(fuse) and res.use_pallas)
        if m == 0:
            # degenerate wide-LU trailing block (columns remain, rows do
            # not): the staged chain handles the empty GEMM
            do_fuse = False
        if do_fuse:
            _counters.inc("kernel.launch")
            items = c.shape[0] if c.ndim == 3 else 1
            with _fk.fused_span("trsm_gemm", res.chain, form=form,
                                flops=items * (nb * nb * n + 2 * m * n * nb),
                                bytes=items * res.chain.fused_hbm_bytes):
                return _fk.trsm_gemm(l11, a_panel, b_left, c, form=form,
                                     unit_diag=unit_diag,
                                     row_block=res.block)
        # staged chain: TRSM then GEMM, X round-tripping device memory -
        # operation for operation the blocked drivers' historical update
        from repro_torch.blas import level3         # lazy: avoid import cycle
        x = level3.trsm(l11, a_panel, lower=True, unit_diag=unit_diag,
                        left=True, policy=res.policy, registry=registry)
        bl = x.mT if form == "syrk" else b_left
        upd = dispatch("gemm", bl, x, policy=res.policy, registry=registry)
        return x, c - upd
    raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
