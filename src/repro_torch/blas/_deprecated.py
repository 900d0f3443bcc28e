"""Deprecation machinery for the d-prefixed BLAS shims (port of
``repro.blas._deprecated``).

Each old routine warns exactly once per process (per routine name) and
then keeps delegating silently; ``stacklevel`` points the warning at the
*caller* of the shim, not at this module. Tests reset the once-set via
:func:`reset_warned`.
"""
from __future__ import annotations

import warnings

_warned: set = set()


def warn_once(old: str, new: str) -> None:
    """One DeprecationWarning per deprecated routine name per process.

    ``stacklevel=3`` skips this helper and the shim body, landing on the
    shim's caller.
    """
    if old in _warned:
        return
    _warned.add(old)
    warnings.warn(
        f"repro_torch.blas.{old} is deprecated; use repro_torch.linalg.{new}, "
        f"whose policy/registry/device come from the active "
        f"repro_torch.linalg.ExecutionContext (this shim keeps its old "
        f"behavior: operand-dtype accumulation and the ambient machine, "
        f"whatever the context sets)",
        DeprecationWarning, stacklevel=3)


def compat(policy=None, use_kernel=None, registry=None, use_pallas=None):
    """The shims' one bridge: (the :mod:`repro_torch.linalg` module, the
    per-call context of the old kwargs,
    :func:`repro_torch.linalg.context.compat_context`). Imported lazily:
    ``linalg`` imports the BLAS modules."""
    from repro_torch import linalg
    from repro_torch.linalg.context import compat_context
    return linalg, compat_context(policy, use_kernel, registry, use_pallas)


def reset_warned() -> None:
    """Forget which shims already warned (tests only)."""
    _warned.clear()
