"""repro_torch.tune - autotuning, policy dispatch and the kernel-config
registry.

Port of ``repro.tune``: the same policies (``reference`` | ``model`` |
``tuned``, default ``REPRO_TUNE_POLICY`` or ``reference``), the same
registry JSON schema and key rule (backend component ``"cuda"`` or
``"cpu"``), the same :class:`Resolution` fields. The loop: the model
proposes configs (:mod:`repro_torch.core.codesign`), a measured sweep
picks among them (:mod:`~repro_torch.tune.search` on
:mod:`~repro_torch.tune.measure`), the registry stores the winner, and
dispatch resolves it under ``tuned`` (a ``tuned`` call with no registry
entry resolves exactly as ``model``).
"""
from repro_torch.tune import dispatch, measure, policy, registry, search
from repro_torch.tune.dispatch import Resolution, dispatch as dispatch_op, resolve
from repro_torch.tune.policy import POLICIES, default_policy, resolve_policy
from repro_torch.tune.registry import KernelConfig, Registry, default_registry

__all__ = [
    "POLICIES", "KernelConfig", "Registry", "Resolution",
    "default_policy", "default_registry", "dispatch", "dispatch_op",
    "measure", "policy", "registry", "resolve", "resolve_policy", "search",
]
