"""repro_torch.tune - policy dispatch and the kernel-config registry.

Port of ``repro.tune`` (policy, registry, dispatch): the same policies
(``reference`` | ``model`` | ``tuned``, default ``REPRO_TUNE_POLICY`` or
``reference``), the same registry JSON schema and key rule (backend
component ``"cuda"`` or ``"cpu"``), the same :class:`Resolution` fields.
Measured sweeps (``measure``, ``search``) are later work; a ``tuned``
call with no registry entry resolves exactly as ``model``.
"""
from repro_torch.tune import dispatch, policy, registry
from repro_torch.tune.dispatch import Resolution, dispatch as dispatch_op, resolve
from repro_torch.tune.policy import POLICIES, default_policy, resolve_policy
from repro_torch.tune.registry import KernelConfig, Registry, default_registry

__all__ = [
    "POLICIES", "KernelConfig", "Registry", "Resolution",
    "default_policy", "default_registry", "dispatch", "dispatch_op",
    "policy", "registry", "resolve", "resolve_policy",
]
