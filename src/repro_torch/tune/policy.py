"""Dispatch policies (port of ``repro.tune.policy``).

``"reference"`` - plain PyTorch, the oracle path.
``"model"``     - the hand-written kernels, analytically planned config.
``"tuned"``     - the kernels, measured config from the registry; a cold
                  start falls back to the ``model`` resolution.

``use_kernel`` (and its older spelling ``use_pallas``) survive as
deprecated aliases: True -> ``"model"``, False -> ``"reference"``.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

POLICIES = ("reference", "model", "tuned")

# policies whose execution path is the kernel
KERNEL_POLICIES = ("model", "tuned")

_ENV_POLICY = "REPRO_TUNE_POLICY"
_warned_aliases: set = set()


def default_policy() -> str:
    """Process-wide default policy (env ``REPRO_TUNE_POLICY``, else
    ``"reference"``)."""
    pol = os.environ.get(_ENV_POLICY, "reference")
    if pol not in POLICIES:
        raise ValueError(
            f"{_ENV_POLICY}={pol!r} is not one of {POLICIES}")
    return pol


def resolve_policy(policy: Optional[str] = None,
                   use_kernel: Optional[bool] = None,
                   use_pallas: Optional[bool] = None) -> str:
    """Collapse (policy, deprecated use_kernel/use_pallas) into one policy.

    An explicit ``policy`` always wins (validated). ``use_kernel``, then
    ``use_pallas``, map True -> ``"model"`` and False -> ``"reference"``;
    each alias warns once per process. With none given,
    :func:`default_policy` applies.
    """
    if policy is not None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}")
        return policy
    for name, flag in (("use_kernel", use_kernel), ("use_pallas", use_pallas)):
        if flag is None:
            continue
        if name not in _warned_aliases:
            _warned_aliases.add(name)
            warnings.warn(
                f"{name} is deprecated; pass policy='model' (True) or "
                f"policy='reference' (False) instead", DeprecationWarning,
                stacklevel=3)
        return "model" if flag else "reference"
    return default_policy()


def uses_kernel(policy: str) -> bool:
    return policy in KERNEL_POLICIES
