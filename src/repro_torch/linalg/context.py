"""Execution contexts: one scoped object replaces per-call kwarg threading.

Port of ``repro.linalg.context``. Every :mod:`repro_torch.linalg` routine
resolves an :class:`ExecutionContext`:

``policy``
    ``"reference" | "model" | "tuned"`` (``None`` = the process default,
    ``REPRO_TUNE_POLICY`` or ``"reference"``).
``registry``
    A :class:`repro_torch.tune.registry.Registry`, a path string (one
    cached ``Registry`` per path), or ``None`` (the process default).
``accum_dtype``
    Optional computation dtype: operands are cast to it and the result is
    cast back to the storage dtype.
``device``
    Where the routine runs: ``"cuda"`` (the default) or ``"cpu"``. It
    replaces the reference's ``interpret`` field. numpy inputs are placed
    on this device; a tensor on another device raises (nothing is moved
    silently); ``"cuda"`` without a card raises ``RuntimeError``.
``machine``
    A :class:`repro_torch.arch.MachineSpec` or registered name the call's
    planners and registry keys resolve against. ``None`` inherits the
    ambient machine: an enclosing ``arch.machine_scope``, else the machine
    of the context's device (``"h100"`` for ``"cuda"``, ``"tpu-like"``
    for ``"cpu"``; :func:`resolved_machine`). The routine body runs under an
    ``arch.machine_scope`` of the resolved machine.
``obs``
    Observability capture: ``None`` inherits the ambient
    :func:`repro_torch.obs.trace`, ``False`` suppresses capture, a
    :class:`repro_torch.obs.Trace` routes the spans into it.

Contexts layer: the module default, then :func:`set_context`, then nested
:func:`use` blocks (a :class:`contextvars.ContextVar`), then a per-call
``context=`` override; unset fields inherit through :data:`UNSET`. The
reference's ``mesh`` field comes with the distributed layer.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from repro_torch import _dtype


class _UnsetType:
    """Sentinel for 'inherit this field from the enclosing context'."""

    _instance: Optional["_UnsetType"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNSET"

    def __bool__(self) -> bool:
        return False


UNSET = _UnsetType()

_FIELDS = ("policy", "registry", "accum_dtype", "device", "machine", "obs")


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """One call's execution recipe; fields left :data:`UNSET` inherit."""

    policy: Any = UNSET
    registry: Any = UNSET
    accum_dtype: Any = UNSET
    device: Any = UNSET
    machine: Any = UNSET
    obs: Any = UNSET

    def __post_init__(self):
        if self.policy is not UNSET and self.policy is not None:
            from repro_torch.tune.policy import POLICIES
            if self.policy not in POLICIES:
                raise ValueError(
                    f"unknown policy {self.policy!r}; expected one of "
                    f"{POLICIES} (or None for the process default)")
        if self.device is not UNSET:
            try:
                kind = torch.device(self.device).type
            except RuntimeError:                    # not a device string
                kind = None
            if kind not in ("cuda", "cpu"):
                raise ValueError(f"device must be 'cuda' or 'cpu'; got "
                                 f"{self.device!r}")
        if self.machine is not UNSET and self.machine is not None:
            from repro_torch.arch import MachineSpec, get as _arch_get
            if isinstance(self.machine, str):
                _arch_get(self.machine)     # unknown names fail eagerly
            elif not isinstance(self.machine, MachineSpec):
                raise ValueError(
                    f"machine must be a MachineSpec, a registered machine "
                    f"name, or None; got {type(self.machine).__name__}")
        if self.obs is not UNSET and self.obs is not None \
                and self.obs is not False:
            from repro_torch.obs import Trace
            if not isinstance(self.obs, Trace):
                raise ValueError(
                    f"obs must be a repro_torch.obs.Trace, False (suppress), "
                    f"or None (inherit); got {type(self.obs).__name__}")

    def over(self, base: "ExecutionContext") -> "ExecutionContext":
        """This context layered over ``base``: set fields win."""
        merged = {f: (getattr(self, f) if getattr(self, f) is not UNSET
                      else getattr(base, f)) for f in _FIELDS}
        return ExecutionContext(**merged)

    def describe(self) -> Dict[str, Any]:
        """JSON-able summary of the resolved context."""
        from repro_torch.tune.policy import default_policy
        pol = self.policy if self.policy not in (UNSET, None) \
            else default_policy()
        reg = self.registry
        if reg is UNSET or reg is None:
            reg_path = None
        elif isinstance(reg, str):
            reg_path = reg
        else:
            reg_path = getattr(reg, "path", None)
        acc = None if self.accum_dtype in (UNSET, None) \
            else _dtype.name(self.accum_dtype)
        mach = resolved_machine(self).name
        if self.obs in (UNSET, None):
            obs_desc = None
        elif self.obs is False:
            obs_desc = False
        else:
            obs_desc = getattr(self.obs, "name", "trace")
        return {"policy": pol, "registry": reg_path, "accum_dtype": acc,
                "device": str(resolved_device_name(self)), "machine": mach,
                "obs": obs_desc}


# fully-resolved root: what a call sees with no context set anywhere
_DEFAULT = ExecutionContext(policy=None, registry=None, accum_dtype=None,
                            device="cuda", machine=None, obs=None)
_base = _DEFAULT
_scopes: "contextvars.ContextVar[Tuple[ExecutionContext, ...]]" = \
    contextvars.ContextVar("repro_torch_linalg_scopes", default=())


def _as_overlay(context, fields: Mapping[str, Any]) -> ExecutionContext:
    if context is not None and fields:
        raise TypeError("pass either a context object or field kwargs, "
                        "not both")
    if context is None:
        return ExecutionContext(**dict(fields))
    if isinstance(context, ExecutionContext):
        return context
    if isinstance(context, Mapping):
        return ExecutionContext(**dict(context))
    raise TypeError(f"context must be an ExecutionContext or mapping; "
                    f"got {type(context).__name__}")


def _active() -> ExecutionContext:
    ctx = _base
    for overlay in _scopes.get():
        ctx = overlay.over(ctx)
    return ctx


def current(call_override=None) -> ExecutionContext:
    """The active context, with an optional per-call overlay on top."""
    ctx = _active()
    if call_override is not None:
        ctx = _as_overlay(call_override, {}).over(ctx)
    return ctx


@contextlib.contextmanager
def use(context=None, **fields) -> Iterator[ExecutionContext]:
    """Scope a context: ``with repro_torch.linalg.use(policy="model"):``."""
    overlay = _as_overlay(context, fields)
    token = _scopes.set(_scopes.get() + (overlay,))
    try:
        yield _active()
    finally:
        _scopes.reset(token)


def set_context(context=None, **fields) -> ExecutionContext:
    """Replace the process-global base context (under any active ``use``)."""
    global _base
    _base = _as_overlay(context, fields).over(_DEFAULT)
    return _base


def get_context() -> ExecutionContext:
    """The currently active (fully layered) context."""
    return _active()


def reset_context() -> None:
    """Reset the global base and this thread's scopes to the default."""
    global _base
    _base = _DEFAULT
    _scopes.set(())


# ------------------------- lazy field normalizers ---------------------------

_registry_cache: Dict[str, Any] = {}


def resolved_registry(ctx: ExecutionContext):
    """ctx.registry as a Registry-or-None (path strings cached per path)."""
    reg = ctx.registry
    if reg is UNSET or reg is None:
        return None
    if isinstance(reg, str):
        if reg not in _registry_cache:
            from repro_torch.tune.registry import Registry
            _registry_cache[reg] = Registry(path=reg)
        return _registry_cache[reg]
    return reg


def resolved_policy(ctx: ExecutionContext):
    """ctx.policy as a policy-string-or-None (None = process default)."""
    return None if ctx.policy is UNSET else ctx.policy


def resolved_accum_dtype(ctx: ExecutionContext):
    return None if ctx.accum_dtype in (UNSET, None) else ctx.accum_dtype


def resolved_device_name(ctx: ExecutionContext) -> torch.device:
    """ctx.device as a torch.device, without checking for a card."""
    return torch.device("cuda" if ctx.device is UNSET else ctx.device)


def resolved_device(ctx: ExecutionContext) -> torch.device:
    """ctx.device as a torch.device; ``RuntimeError`` for ``cuda`` when no
    card is present (the routine does not carry on on the CPU)."""
    dev = resolved_device_name(ctx)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.linalg runs on 'cuda' by default and no CUDA device "
            "is available; ask for the CPU explicitly with "
            "linalg.use(device='cpu')")
    return dev


def resolved_machine(ctx: ExecutionContext):
    """ctx.machine as a MachineSpec (names resolved through the arch
    registry). Unset or ``None``: the ambient machine of the context's
    device, :func:`repro_torch.arch.current_machine` - an enclosing
    ``machine_scope`` or process default, else ``"h100"`` for ``cuda`` and
    ``"tpu-like"`` for ``cpu``. Needs no card."""
    from repro_torch import arch as _arch
    mach = ctx.machine
    if mach is UNSET or mach is None:
        return _arch.current_machine(resolved_device_name(ctx))
    return _arch.resolve_machine(mach)


def resolved_obs(ctx: ExecutionContext):
    """ctx.obs as a Trace-or-None (``UNSET``/``None`` inherit the ambient
    trace; ``False`` resolves to ``None``)."""
    o = ctx.obs
    if o is False:
        return None
    if o is UNSET or o is None:
        from repro_torch.obs import current_trace
        return current_trace()
    return o
