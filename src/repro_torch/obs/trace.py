"""Contextvar-scoped tracer: spans, instant events, roofline annotation.

Port of ``repro.obs.trace``. A :class:`contextvars.ContextVar` holds the
active :class:`Trace` (or ``None``), so concurrent threads and asyncio
tasks each see only their own capture. Observation never changes numerics
and, when disabled, costs one contextvar lookup:

* **Disabled path**: :func:`span` returns a shared no-op singleton; the
  :mod:`repro_torch.linalg` routine wrappers skip even that.
* **Enabled path**: a :class:`Span` records host wall time
  (``time.perf_counter`` relative to the trace epoch), name/category,
  whatever is :meth:`Span.annotate`\\ d, and - when ``flops`` was
  annotated - roofline metrics priced by the ambient
  :class:`repro_torch.arch.MachineSpec` at close.

Host-clock caveat: CUDA work is asynchronous, so a span's wall time is
the time to *enqueue* the work unless the code inside it synchronises.
The reference's spans time the host too; device time per span would be a
field the reference lacks.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch import arch as _arch
from repro_torch.obs import counters as _counters

#: bump when the serialized event layout changes; exporters embed it and
#: ``scripts/trace_report.py --validate`` rejects mismatches
SCHEMA_VERSION = 1

#: the frozen per-event field set every exporter writes
#: (``scripts/check_api_surface.py`` guards it)
EVENT_FIELDS = ("name", "cat", "id", "parent", "t_start", "t_end", "attrs")

_current: "contextvars.ContextVar[Optional[Trace]]" = \
    contextvars.ContextVar("repro_torch_obs_trace", default=None)
_stack: "contextvars.ContextVar[Tuple[Span, ...]]" = \
    contextvars.ContextVar("repro_torch_obs_spans", default=())


def _jsonable(v):
    """Best-effort conversion of annotation values to JSON-able types."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    # numpy scalars and 0-d tensors expose item(); anything else falls
    # back to repr
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return repr(v)


class Trace:
    """One capture: an ordered event list plus the counter delta it saw.

    Created by :func:`trace` (or explicitly and routed through
    ``linalg.use(obs=tr)`` / :func:`capture`). Events are appended as
    spans *close* (children before parents); exporters sort by start
    time. ``counters`` holds the process-counter delta between start and
    :meth:`finish`.
    """

    def __init__(self, name: str = "trace"):
        self.name = str(name)
        self.t0 = time.perf_counter()
        self.events: List["Span"] = []
        self.counters: Dict[str, int] = {}
        self.finished = False
        self._next_id = 0
        self._counters0 = _counters.snapshot()

    def next_id(self) -> int:
        i = self._next_id
        self._next_id = i + 1
        return i

    def finish(self) -> "Trace":
        """Freeze the counter delta (idempotent); called by :func:`trace`
        on scope exit."""
        if not self.finished:
            self.finished = True
            self.counters = _counters.delta(self._counters0)
        return self

    def spans(self, name: Optional[str] = None,
              cat: Optional[str] = None) -> List["Span"]:
        """Events filtered by exact name and/or category."""
        return [e for e in self.events
                if (name is None or e.name == name)
                and (cat is None or e.cat == cat)]

    def __repr__(self) -> str:
        return (f"Trace({self.name!r}, events={len(self.events)}, "
                f"finished={self.finished})")


class _NoopSpan:
    """Shared do-nothing span: the disabled-path return value."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region (or, with ``t_end=None``, one instant event).

    Use as a context manager (via :func:`span`); :meth:`annotate` merges
    attribute dicts at any point before close. Closing computes the
    derived roofline attrs when ``flops`` is present (see module
    docstring) and appends the span to its trace.
    """

    __slots__ = ("trace", "name", "cat", "id", "parent", "t_start", "t_end",
                 "attrs", "_token")

    def __init__(self, trace: Trace, name: str, cat: str,
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace = trace
        self.name = str(name)
        self.cat = str(cat)
        self.id: Optional[int] = None
        self.parent: Optional[int] = None
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._token = None

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        open_spans = _stack.get()
        self.id = self.trace.next_id()
        # parent only within the same trace (capture() can switch traces
        # mid-stack; ids from another trace would dangle)
        self.parent = open_spans[-1].id if open_spans and \
            open_spans[-1].trace is self.trace else None
        self._token = _stack.set(open_spans + (self,))
        self.t_start = time.perf_counter() - self.trace.t0
        return self

    def __exit__(self, *exc) -> bool:
        self.t_end = time.perf_counter() - self.trace.t0
        if self._token is not None:
            _stack.reset(self._token)
            self._token = None
        self._finalize()
        self.trace.events.append(self)
        return False

    # ------------------------- roofline pricing -----------------------------

    def _finalize(self) -> None:
        at = self.attrs
        flops = at.get("flops")
        if flops is None or self.t_end is None or self.t_start is None:
            return
        mach = _arch.current_machine()
        at.setdefault("machine", mach.name)
        wall = self.t_end - self.t_start
        peak = mach.pe.peak_flops
        nbytes = at.get("bytes")
        modeled = flops / peak if peak > 0 else float("nan")
        if nbytes and mach.memory.hbm_bw > 0:
            modeled = max(modeled, nbytes / mach.memory.hbm_bw)
        at["modeled_s"] = modeled
        if wall > 0:
            at["wall_s"] = wall
            at["achieved_gflops"] = flops / wall / 1e9
            if peak > 0:
                at["fraction_of_modeled_peak"] = (flops / wall) / peak
            # same definition as the reference's tune.measure.model_residual
            at["model_residual"] = (wall - modeled) / wall

    def to_dict(self) -> Dict[str, Any]:
        """The frozen :data:`EVENT_FIELDS` record (JSON-able)."""
        return {"name": self.name, "cat": self.cat, "id": self.id,
                "parent": self.parent, "t_start": self.t_start,
                "t_end": self.t_end, "attrs": _jsonable(self.attrs)}

    def __repr__(self) -> str:
        dur = (None if self.t_end is None or self.t_start is None
               else self.t_end - self.t_start)
        return f"Span({self.name!r}, cat={self.cat!r}, dur={dur})"


# ------------------------------ capture scope -------------------------------

def enabled() -> bool:
    """True when a trace is capturing in this context (one var lookup)."""
    return _current.get() is not None


def current_trace() -> Optional[Trace]:
    """The capturing :class:`Trace`, or ``None``."""
    return _current.get()


@contextlib.contextmanager
def trace(name: str = "trace") -> Iterator[Trace]:
    """Capture everything in the dynamic extent into a fresh trace::

        with obs.trace(name="chol") as tr:
            linalg.cholesky(a)
    """
    tr = Trace(name)
    token = _current.set(tr)
    try:
        yield tr
    finally:
        _current.reset(token)
        tr.finish()


@contextlib.contextmanager
def capture(tr: Optional[Trace]) -> Iterator[Optional[Trace]]:
    """Route capture into an existing trace (``None`` suppresses capture -
    how ``linalg.use(obs=False)`` masks an ambient trace)."""
    token = _current.set(tr)
    try:
        yield tr
    finally:
        _current.reset(token)


def span(name: str, cat: str = "custom", **attrs):
    """Open a span under the active trace; a shared no-op when disabled.

    ``with obs.span("linalg.gemm", cat="routine", flops=2*m*n*k): ...``
    """
    tr = _current.get()
    if tr is None:
        return NOOP_SPAN
    return Span(tr, name, cat, attrs)


def event(name: str, cat: str = "instant", **attrs) -> Optional[Span]:
    """Record an instant event (``t_end=None``) under the open span."""
    tr = _current.get()
    if tr is None:
        return None
    ev = Span(tr, name, cat, attrs)
    ev.id = tr.next_id()
    open_spans = _stack.get()
    ev.parent = open_spans[-1].id if open_spans and \
        open_spans[-1].trace is tr else None
    ev.t_start = time.perf_counter() - tr.t0
    tr.events.append(ev)
    return ev


def annotate(**attrs) -> bool:
    """Merge ``attrs`` onto the innermost open span; False if none is
    open (or tracing is disabled) - never raises."""
    open_spans = _stack.get()
    if not open_spans:
        return False
    open_spans[-1].annotate(**attrs)
    return True
