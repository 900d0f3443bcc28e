"""The analyzer's trace: fake tensors, the fake card, host reads and sites.

:func:`trace` runs a function once under ``torch._subclasses``'s
``FakeTensorMode`` and ``make_fx``: no value is computed, nothing launches.
Its operands become fake tensors on the trace's device. On ``cuda`` they
are fake CUDA tensors: the kernel wrappers take the card route and record
the launches they would make (:mod:`repro_torch.kernels.launch_record`),
and :func:`repro_torch.linalg.context.fake_card` lets a ``cuda`` context
run without a card. The aten graph holds everything outside the kernels.

Three things a real run would do differently, each stated:

- **Host reads.** ``aten._local_scalar_dense`` (``.item()``, ``.tolist()``,
  ``int(t)``) has no value on a fake tensor. :class:`TraceMode` answers it
  with a stand-in (:data:`STAND_IN`: 0, 0.0 or False by dtype) and records
  where it happened (the innermost ``repro_torch`` frame); the DF004 rule
  reports each. A pivot read only reorders rows, so the graph after it
  keeps its shapes.
- **Sites.** :func:`site` names the innermost ``repro_torch`` frame of the
  current call (``repro_torch/<path>.py:<function>``, or ``:<line>`` with
  ``line=True``), outside this package: where a product or a host read
  happens.
- **A CPU-only build of PyTorch.** Fake CUDA tensors pass every aten op,
  but four Python bindings (``Tensor.__getitem__``, ``__setitem__``,
  ``contiguous`` and ``copy_``) guard the tensor's device before
  dispatching, and a build without CUDA has no CUDA guard. Inside
  :func:`patched_bindings` (entered only on such a build) those four spell
  the same aten ops out in Python (``select``, ``slice``, ``unsqueeze``,
  ``index``, ``index_put_``, ``copy_``, ``fill_``, ``clone``, ``view``,
  ``expand``) as PyTorch's indexing does, so the trace holds the nodes a
  CUDA build's trace holds: ``tests/test_torch_analysis_bindings.py``
  holds them, on fake CPU tensors, to PyTorch's own bindings node for node.
  A build with CUDA traces with the bindings as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)                 # .../src
_SELF = os.path.dirname(os.path.abspath(__file__))

# the value a fake host read answers with, by the read tensor's dtype kind
STAND_IN = {"int": 0, "float": 0.0, "bool": False, "complex": 0j}


# ----------------------------------- sites -----------------------------------

_code_paths: Dict[Any, Optional[str]] = {}


def _rel(code) -> Optional[str]:
    """``repro_torch/<path>.py`` of a code object in ``repro_torch`` and
    outside this package, else None (cached per code object)."""
    if code not in _code_paths:
        path = os.path.abspath(code.co_filename)
        _code_paths[code] = (
            os.path.relpath(path, _ROOT).replace(os.sep, "/")
            if path.startswith(_PKG + os.sep)
            and not path.startswith(_SELF + os.sep) else None)
    return _code_paths[code]


def site(line: bool = False) -> Optional[str]:
    """``repro_torch/<path>.py:<function>`` (or ``:<line>``) of the
    innermost frame of the current call that lies in ``repro_torch`` and
    outside this package; None when no such frame is on the stack."""
    f = sys._getframe(1)
    while f is not None:
        rel = _rel(f.f_code)
        if rel is not None:
            return f"{rel}:{f.f_lineno if line else f.f_code.co_name}"
        f = f.f_back
    return None


# ------------------------------ the trace's mode -----------------------------

# the contraction ops whose sites BY001 attributes
CONTRACTIONS = ("mm", "bmm", "addmm", "baddbmm", "convolution")


def stand_in(dtype: torch.dtype):
    """The stand-in value of a fake host read of a ``dtype`` tensor."""
    if dtype == torch.bool:
        return STAND_IN["bool"]
    if dtype.is_complex:
        return STAND_IN["complex"]
    return STAND_IN["float"] if dtype.is_floating_point else STAND_IN["int"]


class TraceMode(TorchDispatchMode):
    """The analyzer's dispatch mode, above ``make_fx``'s proxy mode and the
    fake mode: answers ``aten._local_scalar_dense`` with :func:`stand_in`
    and records the read (site ``file:line``, dtype) in ``reads``; records
    each contraction's (site ``file:function``, op) in ``contractions``;
    labels every graph node an op adds with ``node.meta["site"]``
    (``file:line``) when handed the graph being built."""

    def __init__(self, graph=None):
        super().__init__()
        self.graph = graph
        self.reads: List[Tuple[Optional[str], str]] = []
        self.contractions: List[Tuple[Optional[str], str]] = []
        self._known = 0 if graph is None else len(graph.nodes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            dt = args[0].dtype
            self.reads.append((site(line=True),
                               str(dt).replace("torch.", "")))
            return stand_in(dt)
        out = func(*args, **(kwargs or {}))
        name = func._opname.rstrip("_")
        if name in CONTRACTIONS:
            self.contractions.append((site(), name))
        if self.graph is not None and len(self.graph.nodes) > self._known:
            where = site(line=True)
            for node in reversed(self.graph.nodes):
                if "site" in node.meta or node.op != "call_function":
                    break
                node.meta["site"] = where
            self._known = len(self.graph.nodes)
        return out


# ------------------------- fake CUDA on a CPU-only build ---------------------

def needs_patched_bindings(device: torch.device) -> bool:
    """Does a fake trace on ``device`` need :func:`patched_bindings`: fake
    CUDA tensors on a build of PyTorch without CUDA."""
    return device.type == "cuda" and not torch.backends.cuda.is_built()


def _fake_cuda(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) and t.device.type == "cuda"


def _index_tensor(idx, like: torch.Tensor) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx
    return torch.tensor(idx, device=like.device)


def _basic(t: torch.Tensor, index,
           whole_slice: bool = False) -> Tuple[torch.Tensor, List]:
    """Apply the basic parts of ``index`` (ints, slices, None, Ellipsis,
    bools) as PyTorch's indexing does (a slice from 0 by 1 to the end or
    past it is skipped unless it is the whole index of a read,
    ``whole_slice``; an open end slices to ``sys.maxsize``; a step must be
    positive; a 0-d integer tensor is read on the host and selects; a bool
    adds a dim indexed by a one- or zero-element tensor); returns the view
    and the advanced index list over its dims (None where a dim takes no
    tensor)."""
    if not isinstance(index, tuple):
        index = (index,)
    ellipsis_dims = t.dim() - _named_dims(index)
    dim = 0
    adv: List = []
    for i in index:
        if i is Ellipsis:
            dim += ellipsis_dims
            adv.extend([None] * ellipsis_dims)
        elif i is None:
            t = torch.ops.aten.unsqueeze.default(t, dim)
            dim += 1
            adv.append(None)
        elif isinstance(i, bool):
            t = torch.ops.aten.unsqueeze.default(t, dim)
            it = torch.ops.aten.empty.memory_format(
                [int(i)], dtype=torch.long, device=t.device)
            if i:
                it = torch.ops.aten.fill_.Scalar(it, 0)
            dim += 1
            adv.append(it)
        elif isinstance(i, (int, np.integer)):
            t = torch.ops.aten.select.int(t, dim, int(i))
        elif (isinstance(i, torch.Tensor) and i.ndim == 0
              and not i.dtype.is_floating_point and i.dtype != torch.bool):
            t = torch.ops.aten.select.int(t, dim, int(i.item()))
        elif isinstance(i, slice):
            step = 1 if i.step is None else int(i.step)
            if step <= 0:                            # as Python / torch
                raise ValueError("slice step cannot be zero" if step == 0
                                 else "step must be greater than zero")
            start = 0 if i.start is None else int(i.start)
            stop = sys.maxsize if i.stop is None else int(i.stop)
            if whole_slice or not (start == 0 and stop >= t.shape[dim]
                                   and step == 1):
                t = torch.ops.aten.slice.Tensor(t, dim, start, stop, step)
            dim += 1
            adv.append(None)
        else:                                        # tensor / list index
            it = _index_tensor(i, t)
            adv.append(it)
            adv.extend([None] * (it.ndim - 1 if it.dtype == torch.bool
                                 else 0))
            dim += it.ndim if it.dtype == torch.bool else 1
    return t, adv


def _named_dims(index) -> int:
    """Dims of the indexed tensor that ``index`` names explicitly."""
    n = 0
    for i in index:
        if i is None or i is Ellipsis or isinstance(i, bool):
            continue
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            n += i.ndim
        else:
            n += 1
    return n


def _getitem(orig):
    def getitem(self, index):
        if not _fake_cuda(self):
            return orig(self, index)
        view, adv = _basic(self, index, isinstance(index, slice))
        if any(a is not None for a in adv):
            while adv and adv[-1] is None:
                adv.pop()
            return torch.ops.aten.index.Tensor(view, adv)
        if view is self:
            return torch.ops.aten.alias.default(self)
        return view
    return getitem


def _without_leading_ones(shape) -> list:
    """``shape`` without its leading 1s (PyTorch's ``slicePrefix1sSize``)."""
    lead = next((i for i, d in enumerate(shape) if d != 1), len(shape))
    return list(shape[lead:])


def _copy_to(view: torch.Tensor, value: torch.Tensor) -> None:
    """PyTorch's ``at::indexing::copy_to``: ``copy_`` for equal shapes,
    ``fill_`` from a 0-d CPU value, else the value viewed without its
    leading 1s, broadcast and copied."""
    if view.shape == value.shape:
        torch.ops.aten.copy_.default(view, value)
    elif value.ndim == 0 and value.device.type == "cpu":
        torch.ops.aten.fill_.Tensor(view, value)
    else:
        src = torch.ops.aten.view.default(
            value, _without_leading_ones(value.shape))
        if src.shape != view.shape:
            src = torch.ops.aten.expand.default(src, list(view.shape))
        torch.ops.aten.copy_.default(view, src)


def _setitem(orig):
    def setitem(self, index, value):
        if not _fake_cuda(self):
            return orig(self, index, value)
        if not isinstance(value, torch.Tensor):       # as the binding: a
            value = torch.tensor(value, dtype=self.dtype)  # 0-d CPU constant
        if index is False:                            # as the binding
            return None
        view, adv = _basic(self, index)
        if any(a is not None for a in adv):
            while adv and adv[-1] is None:
                adv.pop()
            size = _without_leading_ones(value.shape)
            if len(size) != value.ndim:
                value = torch.ops.aten.view.default(value, size)
            torch.ops.aten.index_put_.default(view, adv, value)
        else:
            _copy_to(view, value)
    return setitem


def _contiguous(orig):
    def contiguous(self, memory_format=torch.contiguous_format):
        if not _fake_cuda(self):
            return orig(self, memory_format=memory_format)
        if self.is_contiguous(memory_format=memory_format):
            return self
        return torch.ops.aten.clone.default(self, memory_format=memory_format)
    return contiguous


def _copy(orig):
    def copy_(self, src, non_blocking=False):
        if not _fake_cuda(self):
            return orig(self, src, non_blocking)
        return torch.ops.aten.copy_.default(self, src, non_blocking)
    return copy_


@contextlib.contextmanager
def patched_bindings():
    """The four device-guarded ``Tensor`` bindings spelled out in aten ops
    for fake CUDA tensors (see the module's note); restored on exit."""
    names = {"__getitem__": _getitem, "__setitem__": _setitem,
             "contiguous": _contiguous, "copy_": _copy}
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n, make in names.items():
            setattr(torch.Tensor, n, make(saved[n]))
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


# ------------------------------ operands and trace ---------------------------

def _leaves(obj, out: List):
    """Flatten the tensors and numpy arrays of ``obj`` (tuples, lists,
    dicts, dataclasses) into ``out``; returns a rebuild function."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        i = len(out)
        out.append(obj)
        return lambda vals: vals[i]
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        parts = [_leaves(o, out) for o in obj]
        kind = type(obj)
        return lambda vals: kind(p(vals) for p in parts)
    if isinstance(obj, dict):
        parts = {k: _leaves(v, out) for k, v in obj.items()}
        return lambda vals: {k: p(vals) for k, p in parts.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        parts = {f.name: _leaves(getattr(obj, f.name), out)
                 for f in dataclasses.fields(obj)}
        return lambda vals: dataclasses.replace(
            obj, **{k: p(vals) for k, p in parts.items()})
    return lambda vals: obj


def fake_leaf(mode, x, device: torch.device):
    """A fake tensor of ``x``'s shape and dtype on ``device``."""
    if isinstance(x, np.ndarray):
        dtype = torch.from_numpy(np.zeros((), x.dtype)).dtype
        shape = x.shape
    else:
        dtype, shape = x.dtype, tuple(x.shape)
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


@dataclasses.dataclass
class Trace:
    """One fake run: the aten graph (None when run without one), what the
    scopes recorded, the host reads and contractions, and the inputs' and
    outputs' (shape, dtype) pairs."""

    graph: Any                        # torch.fx.GraphModule or None
    resolutions: List
    launches: List[Dict]
    collectives: List
    counter_delta: Dict[str, float]
    host_reads: List[Tuple[Optional[str], str]]
    contractions: List[Tuple[Optional[str], str]]
    inputs: List[Tuple[tuple, torch.dtype]]
    outputs: List[Tuple[tuple, torch.dtype]]


def run(build: Callable, device: torch.device) -> Trace:
    """``build()`` inside a fake mode on ``device`` (so what it makes - a
    model's parameters, its batch - is fake), then the ``(fn, args, kw)``
    it returns run once with the record scopes open and no graph: the
    launches, resolutions, host reads and contractions of a whole model
    step at no cost in values or memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.launch_record import record_launches
    from repro_torch.linalg.context import fake_card
    from repro_torch.tune.dispatch import record_resolutions

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    tm = TraceMode()
    with contextlib.ExitStack() as st:
        if needs_patched_bindings(device):
            st.enter_context(patched_bindings())
        st.enter_context(fake_card())
        res = st.enter_context(record_resolutions())
        launches = st.enter_context(record_launches())
        st.enter_context(mode)
        fn, args, kw = build()
        with torch.no_grad(), tm:
            fn(*args, **kw)
    return Trace(None, list(res), list(launches), [], {}, list(tm.reads),
                 list(tm.contractions), [], [])


def trace(fn: Callable, args: tuple, kw: dict, device: torch.device,
          decompose: bool = False) -> Trace:
    """Run ``fn(*args, **kw)`` once on fake tensors on ``device`` under
    ``make_fx`` with the dispatcher's, the kernels' and the collectives'
    record scopes open (``decompose``: with
    :data:`repro_torch.core.fx_census.DECOMPOSE` applied, as the census
    traces); tensors and numpy arrays anywhere in ``args`` / ``kw`` become
    fake inputs of their shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

    from repro_torch.distributed.collectives import record_collectives
    from repro_torch.kernels.launch_record import record_launches
    from repro_torch.linalg.context import fake_card
    from repro_torch.obs import counters as _counters
    from repro_torch.tune.dispatch import record_resolutions

    flat: List = []
    rebuild = _leaves((args, kw), flat)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = [fake_leaf(mode, x, device) for x in flat]
    modes: List[TraceMode] = []
    outs: List = []

    def flat_fn(*ts):
        a, k = rebuild(list(ts))
        tm = TraceMode(get_proxy_mode().tracer.graph)
        modes.append(tm)
        with tm:
            out = fn(*a, **k)
        outs.append(out)
        return out

    before = _counters.snapshot()
    with contextlib.ExitStack() as st:
        if needs_patched_bindings(device):
            st.enter_context(patched_bindings())
        st.enter_context(fake_card())
        res = st.enter_context(record_resolutions())
        launches = st.enter_context(record_launches())
        coll = st.enter_context(record_collectives())
        st.enter_context(mode)
        table = None
        if decompose:
            from torch._decomp import get_decompositions

            from repro_torch.core.fx_census import DECOMPOSE
            table = get_decompositions(list(DECOMPOSE))
        gm = make_fx(flat_fn, tracing_mode="real",
                     decomposition_table=table)(*fakes)
    out_leaves: List = []
    _leaves(outs[0] if outs else None, out_leaves)
    return Trace(gm, list(res), list(launches), list(coll),
                 _counters.delta(before), list(modes[0].reads),
                 list(modes[0].contractions),
                 [(tuple(f.shape), f.dtype) for f in fakes],
                 [(tuple(o.shape), o.dtype) for o in out_leaves
                  if isinstance(o, torch.Tensor)])
