"""Dispatch policies (port of ``repro.tune.policy``).

``"reference"`` - plain PyTorch, the oracle path.
``"model"``     - the hand-written kernels, analytically planned config.
``"tuned"``     - the kernels, measured config from the registry; a cold
                  start falls back to the ``model`` resolution.

The deprecated ``use_kernel``/``use_pallas`` aliases of the reference
come with the port of its d-prefixed shims.
"""
from __future__ import annotations

import os
from typing import Optional

POLICIES = ("reference", "model", "tuned")

# policies whose execution path is the kernel
KERNEL_POLICIES = ("model", "tuned")

_ENV_POLICY = "REPRO_TUNE_POLICY"


def default_policy() -> str:
    """Process-wide default policy (env ``REPRO_TUNE_POLICY``, else
    ``"reference"``)."""
    pol = os.environ.get(_ENV_POLICY, "reference")
    if pol not in POLICIES:
        raise ValueError(
            f"{_ENV_POLICY}={pol!r} is not one of {POLICIES}")
    return pol


def resolve_policy(policy: Optional[str] = None) -> str:
    """An explicit ``policy``, validated; ``None`` = :func:`default_policy`."""
    if policy is None:
        return default_policy()
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    return policy


def uses_kernel(policy: str) -> bool:
    return policy in KERNEL_POLICIES
