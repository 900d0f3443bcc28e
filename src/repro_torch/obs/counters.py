"""Process-global monotonic counters (port of ``repro.obs.counters``).

Counters are the cheap half of :mod:`repro_torch.obs`: unconditional
integer increments (one dict ``+=`` per occurrence, no contextvar
lookup), so the layers that matter can account every occurrence - even
when no trace is active. A :class:`repro_torch.obs.Trace` snapshots the
counter table at start and again at finish, so each trace reports the
*delta* it covered.

The names below are the reference's frozen vocabulary, kept unchanged:

``dispatch.resolve``
    One per :func:`repro_torch.tune.dispatch.resolve` call - every
    kernel-shaped BLAS/LAPACK core resolves exactly once per call.
``dispatch.registry_hit`` / ``dispatch.registry_miss``
    Tuned-policy resolutions that found / missed a registry config
    (miss == ``source="fallback-model"``).
``registry.load``
    :meth:`repro_torch.tune.registry.Registry.load` invocations.
``registry.missing_fallback``
    Loads that found no file (cold start - normal, not warned).
``registry.corrupt_fallback``
    Loads that found an unreadable/schema-incompatible file (warned once
    per path via ``warnings.warn``).
``kernel.launch``
    Kernel launches funneled through the dispatcher (each kernel wrapper
    also keeps its own launch count).
``collective.hops`` / ``collective.bytes``
    Ring-broadcast hops and on-wire bytes
    (:func:`repro_torch.distributed.collectives.ring_bcast`, once per
    call); the trainer's sharding adds the bytes its ZeRO gathers and
    reduce-scatters over the DP axes bring to a rank.

Two names are the port's own, outside the frozen tuple:
``shard.redistribute_bytes``, the bytes that reach a rank where
:mod:`repro_torch.distributed.sharding` gathers a sharded layout over a
non-DP axis (its docstring lists the places), and
``shard.tp_all_reduce_bytes``, the share of ``collective.bytes`` that its
tensor-parallel all-reduces over "model" bring to a rank.
"""
from __future__ import annotations

from typing import Dict

# the frozen counter vocabulary (see module docstring); incrementing an
# unlisted name is allowed (prototyping) but the API-surface guard keeps
# this tuple in sync with what shipping code uses
KNOWN_COUNTERS = (
    "dispatch.resolve",
    "dispatch.registry_hit",
    "dispatch.registry_miss",
    "registry.load",
    "registry.missing_fallback",
    "registry.corrupt_fallback",
    "kernel.launch",
    "collective.hops",
    "collective.bytes",
)

_counts: Dict[str, int] = {}


def inc(name: str, n: int = 1) -> int:
    """Add ``n`` to counter ``name`` (created at 0); returns the new value."""
    v = _counts.get(name, 0) + int(n)
    _counts[name] = v
    return v


def value(name: str) -> int:
    """Current value of ``name`` (0 if never incremented)."""
    return _counts.get(name, 0)


def snapshot() -> Dict[str, int]:
    """Copy of the whole counter table (monotonic; never reset by traces)."""
    return dict(_counts)


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counters that moved since ``before`` (a :func:`snapshot`), as
    name -> increment. Names absent from ``before`` count from 0."""
    return {k: v - before.get(k, 0) for k, v in _counts.items()
            if v != before.get(k, 0)}


def reset() -> None:
    """Zero every counter (tests only - counters are process-monotonic;
    shipping code should diff :func:`snapshot`\\ s instead)."""
    _counts.clear()
