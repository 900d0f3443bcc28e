"""Persistent kernel-config registry (port of ``repro.tune.registry``).

The JSON file format (schema version 1) and the key rule are the
reference's, so a registry written by either package resolves in the
other. Winning sweep configs are cached as JSON keyed by
``(op, shape-bucket, dtype, backend[, mesh][, machine])`` (the reference
``repro.tune`` docstring gives the exact file format; the optional mesh component scopes
distributed ops to one device-mesh shape, and the optional machine
component scopes entries tuned under a non-default
:class:`repro_torch.arch.MachineSpec` - the default machine omits it, so every
pre-arch registry file keeps resolving unchanged). Loading is lazy and
*graceful*: a missing, unreadable, or schema-incompatible file yields an
empty registry - dispatch then falls back to the model-predicted plan, so
a broken cache can never change numerics, only speed. Graceful is not
silent, though: a *corrupt* file fires a once-per-path
``warnings.warn(RuntimeWarning)`` and the ``registry.corrupt_fallback``
counter (a cold start - no file at all - is normal and only counts
``registry.missing_fallback``), so losing tuned configs to a bad cache
shows up instead of just running slower.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from collections import OrderedDict
from typing import Dict, Mapping, Optional, Sequence, Set, Tuple

from repro_torch import _dtype
from repro_torch.obs import counters as _counters

SCHEMA_VERSION = 1
_ENV_PATH = "REPRO_TUNE_REGISTRY"
DEFAULT_PATH = os.path.join(os.path.expanduser("~"), ".cache", "repro-tune",
                            "registry.json")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One tuned (or model-seeded) kernel configuration.

    params holds op-specific integers: ``{"bm","bn","bk"}`` for gemm,
    ``{"block"}`` for trsm. ``source`` records provenance ("sweep" for a
    measured winner, "model" for an analytically seeded entry).
    """

    op: str
    params: Mapping[str, int]
    source: str = "sweep"
    measured_s: Optional[float] = None

    def to_json(self) -> Dict:
        return {"op": self.op, "params": dict(self.params),
                "source": self.source, "measured_s": self.measured_s}

    @classmethod
    def from_json(cls, d: Mapping) -> "KernelConfig":
        params = {str(k): int(v) for k, v in dict(d["params"]).items()}
        return cls(op=str(d["op"]), params=params,
                   source=str(d.get("source", "sweep")),
                   measured_s=d.get("measured_s"))


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    """Round every dim up to the next power of two (>= 1), so one sweep
    covers a neighborhood of problem sizes instead of one exact shape."""
    out = []
    for d in shape:
        d = max(int(d), 1)
        out.append(1 << (d - 1).bit_length())
    return tuple(out)


def make_key(op: str, shape: Sequence[int], dtype, backend: str,
             mesh: Optional[str] = None,
             machine: Optional[str] = None) -> str:
    """Registry key ``op|shape-bucket|dtype|backend[|mesh][|m:machine]``.

    ``mesh`` is the device-mesh component for distributed ops (e.g.
    ``"x2y4"`` for a 2x4 ("x", "y") mesh). ``machine`` is the machine
    name for entries tuned under a non-default
    :class:`repro_torch.arch.MachineSpec` (``m:``-prefixed so it can never
    collide with a mesh component). Single-device, default-machine
    entries omit both, so every pre-mesh/pre-arch registry file keeps
    resolving unchanged.
    """
    bucket = "x".join(str(d) for d in shape_bucket(shape))
    key = f"{op}|{bucket}|{_dtype.name(dtype)}|{backend}"
    if mesh is not None:
        key = f"{key}|{mesh}"
    return key if machine is None else f"{key}|m:{machine}"


# corrupt-registry warn-once bookkeeping (per absolute path, process-wide;
# re-loading the same broken file still counts, but warns only once)
_warned_corrupt_paths: Set[str] = set()


class Registry:
    """JSON-backed config store with LRU semantics.

    ``capacity`` bounds the number of in-memory (and persisted) entries;
    the least recently *used* entry is evicted first. All mutations mark
    the registry dirty; call :meth:`save` to persist.
    """

    def __init__(self, path: Optional[str] = None, capacity: int = 256,
                 autoload: bool = True):
        self.path = path if path is not None else os.environ.get(
            _ENV_PATH, DEFAULT_PATH)
        self.capacity = int(capacity)
        self._entries: "OrderedDict[str, KernelConfig]" = OrderedDict()
        self._loaded = not autoload
        self.load_error: Optional[str] = None
        self.dirty = False

    # ------------------------------ persistence -----------------------------

    def load(self, path: Optional[str] = None) -> int:
        """Read entries from disk (replacing in-memory state). Returns the
        number of entries loaded; 0 with ``load_error`` set on any failure
        (missing file, bad JSON, wrong schema) - never raises. A missing
        file is a normal cold start (counted as
        ``registry.missing_fallback``); a *corrupt* file additionally
        warns once per path (``RuntimeWarning``) and increments
        ``registry.corrupt_fallback`` - the fallback to model-planned
        configs changes speed, never numerics, but it should not be
        silent."""
        self._loaded = True
        self._entries.clear()
        self.load_error = None
        p = path or self.path
        _counters.inc("registry.load")
        try:
            with open(p) as f:
                blob = json.load(f)
            if not isinstance(blob, dict) or blob.get("version") != SCHEMA_VERSION:
                raise ValueError(
                    f"registry schema mismatch: want version={SCHEMA_VERSION}, "
                    f"got {blob.get('version') if isinstance(blob, dict) else type(blob)}")
            for key, d in blob.get("entries", {}).items():
                self._entries[str(key)] = KernelConfig.from_json(d)
        except FileNotFoundError:
            self.load_error = f"no registry file at {p} (cold start)"
            _counters.inc("registry.missing_fallback")
        except (OSError, ValueError, KeyError, TypeError) as e:
            self.load_error = f"unreadable registry at {p}: {e}"
            self._entries.clear()
            _counters.inc("registry.corrupt_fallback")
            ap = os.path.abspath(p)
            if ap not in _warned_corrupt_paths:
                _warned_corrupt_paths.add(ap)
                warnings.warn(
                    f"tune registry at {p} is unreadable ({e}); falling "
                    f"back to model-planned configs (numerics unchanged, "
                    f"tuned speed lost)", RuntimeWarning, stacklevel=2)
        return len(self._entries)

    def save(self, path: Optional[str] = None) -> str:
        p = path or self.path
        d = os.path.dirname(os.path.abspath(p))
        os.makedirs(d, exist_ok=True)
        blob = {"version": SCHEMA_VERSION,
                "entries": {k: v.to_json() for k, v in self._entries.items()}}
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            # entries keep insertion (= recency) order so the LRU order
            # survives a save/load round-trip; don't sort keys
            json.dump(blob, f, indent=1)
        os.replace(tmp, p)
        self.dirty = False
        return p

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self.load()

    # -------------------------------- access --------------------------------

    def lookup(self, op: str, shape: Sequence[int], dtype, backend: str,
               mesh: Optional[str] = None,
               machine: Optional[str] = None) -> Optional[KernelConfig]:
        """LRU lookup; None on miss (dispatch falls back to the model).

        ``mesh`` scopes the key to one device-mesh shape (distributed ops);
        ``machine`` to one non-default machine spec; ``None`` is the
        single-device / default-machine namespace.
        """
        self._ensure_loaded()
        key = make_key(op, shape, dtype, backend, mesh, machine)
        cfg = self._entries.get(key)
        if cfg is not None:
            self._entries.move_to_end(key)
        return cfg

    def record(self, op: str, shape: Sequence[int], dtype, backend: str,
               params: Mapping[str, int], source: str = "sweep",
               measured_s: Optional[float] = None,
               mesh: Optional[str] = None,
               machine: Optional[str] = None) -> KernelConfig:
        self._ensure_loaded()
        key = make_key(op, shape, dtype, backend, mesh, machine)
        cfg = KernelConfig(op=op, params={k: int(v) for k, v in params.items()},
                           source=source, measured_s=measured_s)
        self._entries[key] = cfg
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)       # evict least recently used
        self.dirty = True
        return cfg

    def clear(self) -> None:
        self._entries.clear()
        self.dirty = True

    def keys(self):
        self._ensure_loaded()
        return list(self._entries.keys())

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self._entries)


_default: Optional[Registry] = None


def default_registry() -> Registry:
    """Process-wide registry (path from ``REPRO_TUNE_REGISTRY`` or the
    user cache dir); created lazily, loaded lazily."""
    global _default
    if _default is None:
        _default = Registry()
    return _default


def set_default_registry(reg: Optional[Registry]) -> None:
    """Swap the process-wide registry (tests; ``None`` resets to lazy)."""
    global _default
    _default = reg


def set_default_path(path: str) -> Registry:
    """Point the process-wide registry at ``path`` and return it."""
    global _default
    _default = Registry(path=path)
    return _default
