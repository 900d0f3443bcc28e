"""Cost of a traced step at the aten level (the port's counterpart of
``repro.core.hlo_cost``).

The reference re-derives the roofline inputs from XLA's optimized HLO
text. PyTorch compiles no HLO: here a :class:`CostMode`, a
``TorchDispatchMode``, sees every aten op a step dispatches (below
autograd, so the backward and a remat's recompute show as the ops they
run) and prices each one under the reference's conventions
(``hlo_cost.py:183-323``):

* a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``)
  costs 2 x result elements x contraction size;
* each op of the reference's ``_ELEMENTWISE_FLOP_OPS`` in its aten
  spelling (:data:`ELEMENTWISE`) costs 1 flop per result element; the few
  aten ops that stand for a chain of them (``silu``, ``_softmax``, their
  backwards, ...) cost that chain's length per element
  (:data:`COMPOSITE`); a reduction costs 1 flop per input element;
* ``bytes`` is every op's tensor operands plus its result (the
  reference's upper bound); an aten view moves nothing and costs nothing;
* ``bytes_fused`` counts only what the reference's TPU-fusion model keeps:
  products, copies, ``cat``, gathers, scatters, sorts, pads and the
  collectives; elementwise chains and reductions are taken as fused into
  a product's epilogue. An in-place cache write (``copy_`` into a view,
  ``index_copy_``, ``index_put_``) costs 2 x the update, not the whole
  cache, as a gather costs 2 x what it reads out;
* ``coll`` holds the c10d collectives under the reference's kind names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``): the operand bytes each participant puts in
  (:data:`COLLECTIVE_OPERAND`), as the reference reads them off HLO.

There are no trip counts: the port's layers, microbatches and attention
blocks unroll in Python, so each iteration dispatches its own ops and is
counted once per run. ``parse_module``, ``_trip_count`` and ``analyze``
(the HLO parser) have no counterpart, since nothing in the port emits HLO.

A tensor subclass that reaches the mode (a DTensor the step adds to) is
priced on its local shard: the trace is one rank's.

:class:`CostMode` also tracks memory: every storage an op allocates is
live until its last tensor dies (a weak reference to the untyped storage
calls back), so ``peak`` is the most extra memory the traced step held at
once, beside what lived before it (the rank's state and batch): the
counterpart of the reference's ``memory_analysis`` (argument + output -
aliased + temp, ``roofline.py:245-250``). The state is updated in place
(the port's ``donate_argnums=(0,)``), so its outputs alias its arguments.
It keeps a per-op table too (calls, flops, bytes, fused bytes, collective
bytes by aten op name).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the reference's _ELEMENTWISE_FLOP_OPS in aten spelling (overload and
# in-place suffix stripped): 1 flop per result element
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "expm1",
    "log1p", "cos", "sin", "atan2", "remainder", "fmod", "floor", "ceil",
    "round", "trunc", "erf", "eq", "ne", "lt", "le", "gt", "ge", "where",
    "masked_fill", "clamp", "clamp_min", "clamp_max", "_to_copy",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "sign",
    "reciprocal", "exp2", "log2", "square", "nan_to_num", "lerp",
})
# aten ops that stand for a chain of the reference's elementwise ops (and
# their reductions): flops per result element, the chain's length
COMPOSITE = {
    "silu": 2, "silu_backward": 4, "gelu": 5, "gelu_backward": 8,
    "relu": 1, "threshold_backward": 2, "sigmoid_backward": 3,
    "tanh_backward": 3, "_softmax": 5, "_log_softmax": 5,
    "_softmax_backward_data": 4, "_log_softmax_backward_data": 4,
    "addcmul": 2, "addcdiv": 2, "softplus": 3, "softplus_backward": 4,
}
# reductions: 1 flop per input element
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "var", "std", "var_mean", "norm",
    "linalg_vector_norm", "any", "all",
})
PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "convolution",
                      "convolution_backward"})
# byte-only ops the fused-traffic model keeps (the reference's copy /
# concatenate / sort / scatter / gather / slice / pad)
FUSED_BYTES = frozenset({
    "copy", "clone", "cat", "stack", "sort", "topk", "constant_pad_nd",
    "gather", "index", "index_select", "embedding", "scatter",
    "scatter_add", "scatter_reduce", "index_put", "_index_put_impl",
    "index_copy", "index_add", "slice_scatter", "select_scatter",
    "embedding_dense_backward", "masked_scatter",
})
# ops whose bytes are 2 x their result (a gather reads what it writes)
_READ_OUT = frozenset({"gather", "index", "index_select", "embedding"})
# in-place writes of an update into a larger buffer: 2 x the update
_UPDATE_ARG = {"index_put": 2, "_index_put_impl": 2, "index_copy": 3,
               "index_add": 3, "slice_scatter": 1, "select_scatter": 1,
               "scatter": 3, "scatter_add": 3, "scatter_reduce": 3}
# ops that allocate and write their result, reading nothing
_CREATE = frozenset({
    "zeros", "ones", "full", "fill", "zero", "arange", "scalar_tensor",
    "new_zeros", "new_ones", "new_full", "zeros_like", "ones_like",
    "full_like", "eye", "tril_indices", "triu_indices", "bernoulli",
    "uniform", "normal", "randn", "rand", "randint", "randperm",
})
# ops that move no bytes (allocation without a write, metadata, host reads)
_FREE = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "set", "resize", "wait", "wait_tensor",
    "_has_compatible_shallow_copy_type", "record_stream", "_unsafe_view",
})
# c10d ops -> (kind, index of the operand argument) for the operand bytes
# each participant puts in; "send" carries a collective-permute's buffer
# (its receive is the same transfer and is not counted again)
COLLECTIVE_OPERAND = {
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}
_C10D = ("c10d", "_c10d_functional")
_SCALAR = torch.ops.aten._local_scalar_dense.default
_DEVICE = torch.ops.prim.device.default


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0            # every op's operands + result (upper bound)
    bytes_fused: float = 0.0      # the fused-traffic model: products, copies,
                                  # gathers / scatters, collectives only
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.bytes_fused += o.bytes_fused
        for k, v in o.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v
        return self

    def scaled(self, f: float) -> "Cost":
        return Cost(self.flops * f, self.bytes * f, self.bytes_fused * f,
                    {k: v * f for k, v in self.coll.items()})

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


def _local(t):
    """A tensor subclass's local shard (a DTensor's), else ``t``."""
    inner = getattr(t, "_local_tensor", None)
    return t if inner is None else inner


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        out.append(_local(x))
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x, []))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x, []))


def base_name(func) -> str:
    """An op's name without namespace, overload or in-place suffix
    (``aten.add_.Tensor`` -> ``add``); c10d names keep their suffix."""
    name = func._opname
    if func.namespace in _C10D:
        return name
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


# per op overload: (base name, namespace, is a view, every result fresh)
_INFO: Dict = {}


def _info(func) -> tuple:
    info = _INFO.get(func)
    if info is None:
        fresh = func.namespace == "aten" and not any(
            r.alias_info is not None for r in func._schema.returns)
        info = _INFO[func] = (base_name(func), func.namespace, func.is_view,
                              fresh)
    return info


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "bmm"):
        return 2.0 * _numel(out) * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * _numel(out) * args[1].shape[-1]
    weight = _local(args[1])
    per_out = math.prod(weight.shape[1:])
    if name == "convolution":
        if args[6]:                          # transposed: per input element
            return 2.0 * _local(args[0]).numel() * per_out
        return 2.0 * _numel(out) * per_out
    # convolution_backward(grad_out, input, weight, ..., output_mask): each
    # requested gradient costs the forward's product
    fwd = 2.0 * _local(args[0]).numel() * per_out
    return fwd * sum(bool(m) for m in args[-1][:2])


def op_cost(func, args, kwargs, out) -> Cost:
    """The :class:`Cost` of one dispatched op (module docstring)."""
    name, namespace, is_view, _ = _info(func)
    if namespace in _C10D:
        spec = COLLECTIVE_OPERAND.get(name)
        if spec is None:
            return Cost()
        kind, i = spec
        operand = _nbytes(args[i])
        moved = float(operand + _nbytes(args[0] if i else out))
        return Cost(0.0, moved, moved, {kind: float(operand)})
    if name in _FREE or is_view or namespace == "prim":
        return Cost()
    out_bytes = _nbytes(out)
    if name in _CREATE:
        return Cost(0.0, float(out_bytes), 0.0)
    if name == "copy":                       # dst (a view or not) <- src
        moved = float(_nbytes(args[0]) + _nbytes(args[1]))
        return Cost(0.0, moved, moved)
    if name in _UPDATE_ARG and len(args) > _UPDATE_ARG[name]:
        upd = _nbytes(args[_UPDATE_ARG[name]])
        moved = float(2 * (upd if upd else out_bytes))
        return Cost(0.0, moved, moved)
    if name in _READ_OUT:
        moved = float(2 * out_bytes)
        return Cost(0.0, moved, moved)
    in_bytes = _nbytes(args) + _nbytes(list(kwargs.values()))
    moved = float(in_bytes + out_bytes)
    if name in PRODUCTS:
        return Cost(_product_flops(name, args, out), moved, moved)
    if name.startswith("_foreach_"):
        inner = name[len("_foreach_"):].rstrip("_")
        per = 1 if inner in ELEMENTWISE else COMPOSITE.get(inner, 0)
        return Cost(float(per * _numel(args[0])), moved, 0.0)
    if name in ELEMENTWISE:
        return Cost(float(_numel(out)), moved, 0.0)
    if name in COMPOSITE:
        return Cost(float(COMPOSITE[name] * _numel(out)), moved, 0.0)
    if name in REDUCTIONS:
        return Cost(float(_numel(args[0])), moved, 0.0)
    return Cost(0.0, moved, moved if name in FUSED_BYTES else 0.0)


def _storage_key(t) -> Optional[int]:
    try:
        return _local(t).untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return None


def cost_of_table(ops: Dict[str, List[float]]) -> Cost:
    """The :class:`Cost` a :class:`CostMode`'s per-op table ``ops`` adds
    up to ({name: [calls, flops, bytes, bytes_fused, coll bytes]}, as the
    dry run writes it beside each row): a c10d op's collective bytes go
    under its kind (:data:`COLLECTIVE_OPERAND`). The counts are whole
    numbers, so the sum is the trace's own in any order."""
    total = Cost()
    for name, (_, flops, nbytes, fused, coll) in ops.items():
        kinds = {}
        if coll:
            namespace, _, op = name.partition("::")
            kind = COLLECTIVE_OPERAND.get(op.split(".")[0]) \
                if namespace in _C10D else None
            if kind is None:
                raise ValueError(f"per-op table: {name} moves {coll} "
                                 f"collective bytes but is no collective "
                                 f"of {tuple(COLLECTIVE_OPERAND)}")
            kinds = {kind[0]: float(coll)}
        total += Cost(float(flops), float(nbytes), float(fused), kinds)
    return total


class CostMode(TorchDispatchMode):
    """Prices every aten op dispatched inside it into ``cost`` (module
    docstring) and per op name into ``ops`` ({name: [calls, flops, bytes,
    bytes_fused, coll bytes]}); tracks the storages ops allocate: ``live``
    bytes now, ``peak`` the most at once; ``products`` holds the products'
    flops by result dtype (their peak rates differ). A host read of a fake
    tensor (``aten._local_scalar_dense``, which has no value there) returns
    :func:`repro_torch.analysis.fake_card.stand_in`'s value and counts in
    ``host_reads``; a real tensor's is read. Metadata queries (the
    ``prim`` ops) pass through uncounted."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops: Dict[str, List[float]] = {}
        self.host_reads = 0
        self.products: Dict[str, float] = {}   # product flops by dtype
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}

    def _free(self, key: int, _ref=None) -> None:
        self._refs.pop(key, None)
        self.live -= self._sizes.pop(key, 0)

    def _track(self, fresh: bool, args, out) -> None:
        """Count the storages of ``out`` that the op allocated: all of a
        fresh op's (no result aliases an input), else those no input
        holds."""
        outs = _tensors(out, [])
        if not outs:
            return
        seen = set() if fresh else {_storage_key(t)
                                    for t in _tensors(args, [])}
        for t in outs:
            key = _storage_key(t)
            if key is None or key in seen or key in self._sizes:
                continue
            seen.add(key)
            st = t.untyped_storage()
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            self._refs[key] = weakref.ref(st, functools.partial(self._free,
                                                                key))
        if self.live > self.peak:
            self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE or func.namespace == "prim":
            return func(*args, **kwargs)
        if func is _SCALAR and isinstance(_local(args[0]), FakeTensor):
            # the analyzer's stand-ins (imported here: analysis imports core)
            from repro_torch.analysis.fake_card import stand_in
            self.host_reads += 1
            return stand_in(args[0].dtype)
        out = func(*args, **kwargs)
        c = op_cost(func, args, kwargs, out)
        self.cost += c
        name, _, _, fresh = _INFO[func]
        if c.flops and name in PRODUCTS:
            dt = str(_tensors(out, [])[0].dtype).replace("torch.", "")
            self.products[dt] = self.products.get(dt, 0.0) + c.flops
        row = self.ops.setdefault(str(func.name()), [0, 0.0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += c.flops
        row[2] += c.bytes
        row[3] += c.bytes_fused
        row[4] += c.collective_bytes
        self._track(fresh, args, out)
        return out
