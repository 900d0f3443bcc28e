"""Sharding rules and the trainer's DP x TP x ZeRO state on DTensor (port of
``repro.distributed.sharding``).

**The rules** are the reference's, leaf for leaf:

* batch over ``("pod", "data")`` (:func:`batch_axes`),
* Megatron TP over ``"model"``: column-parallel in-projections
  (``wq wk wv w_in w_gate in_proj router``), row-parallel out-projections
  (``wo w_out out_proj``), vocab-sharded ``table`` and ``head``, MoE experts
  over ``"model"`` in E, ``frontend_proj`` column-parallel,
* ZeRO: the largest still-replicated dim goes over the DP axes,
* a dim that does not divide its axes stays replicated, so one rule set
  serves every (arch x shape x mesh) cell,
* f32 moments follow their parameter; an 8-bit moment's codes shard their
  block dim over the DP axes, its scales stay replicated,
* caches: batch over DP, ``k v cross_k cross_v`` sequence over ``"model"``,
  SSM ``state`` heads over ``"model"``.

A spec is a :class:`P`: a tuple whose entries are ``None``, an axis name or
a tuple of axis names (``P(None, ("pod", "data"))``). A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` or a plain ``{axis:
size}`` mapping; the rules need only the sizes, so a dry run prices a 256-
or 512-rank mesh with no process group. The port keys each layer
(``blocks/3/attn/wq``) where the reference stacks them
(``blocks/attn/wq``, shape (L, ...)): a port leaf's spec is the
reference's without its leading layer ``None``. 8-bit moments differ
more: the port quantizes one layer's parameter, the reference the stack,
so the block counts (and whether they divide the DP size) differ; the
rule is the same on each side's own shape.

**Placement.** :func:`to_shardings` turns a spec into DTensor placements:
an axis named in entry ``i`` is ``Shard(i)`` on that mesh dim, a tuple
entry ``("pod", "data")`` is ``Shard(i)`` on both, in mesh order (jax's
major-to-minor), every other mesh dim ``Replicate()``. The state is SPMD,
as the port's mesh routines are: every rank builds the same full tensors
from the same seed and keeps its own block (:func:`distribute`, by
``DTensor.from_local``, no communication), so each rank's local ``numel``
is the global one over the sizes of the axes the spec names.

**Compute** (TP over "model" inside the blocks, ZeRO-3 over the DP
axes): the DTensors hold the state; the model runs on plain tensors. Each
rank runs the forward and backward on its own rows of the batch (batch
over the DP axes); every rank of a "model" group runs the same rows, and
the residual stream between the layers is whole on each of them. A
block's parameters are swapped in when the block starts (a forward
pre-hook, as FSDP's unshard; again in the backward when remat recomputes
it), as are the parameters outside the blocks for the whole forward (a
hook on the root module): each is all-gathered over the DP axes, and over
"model" too unless it stays this rank's block there. A leaf stays split
over "model" where its spec splits it and the module that owns it lists
it in its ``TP_LEAVES``; the module then finds its :class:`TPSplit`
(which dim is split, the axis's size and this rank's index, and the
axis's ops) and runs its products tensor-parallel, as Megatron-LM does
(``models/layers.py``, ``attention.py``, ``mamba2.py``): a
column-parallel product (``wq wk wv w_in w_gate in_proj``, the head,
``frontend_proj``) takes its input through :class:`_TPCopy` (the
identity forward, its gradient all-reduced over "model" backward) and
gives this rank's columns; a row-parallel one (``wo w_out out_proj``)
multiplies this rank's slice of the features and :class:`_TPReduce`
all-reduces the partial result over "model" (the identity backward); the
vocab-split ``table`` looks up this rank's ids and all-reduces, and the
loss over the vocab-split logits reduces its maximum, sum of exponentials
and the target's logit over "model" (``train/losses.py``); the moe FFN
runs its block of experts (split over "model" in E) on its window of
their capacity slots, exchanged over the DP axes, and sums its experts'
outputs over "model" (``models/moe.py``). A leaf that its spec leaves
whole over "model" (the norms, the biases, hymba's 32001-wide head) or
that no module lists (the moe's ``router``) is gathered whole and its
product runs whole. A parameter's gradient is cut to this
rank's block over the non-DP axes where the leaf was gathered over them
(the same on each of their ranks, so no bytes move) or is that block
already (a TP leaf), then reduce-scattered over the DP axes (summed, then
divided by their size: the mean over the global batch), back to the
parameter's placements. The transport is
:mod:`repro_torch.distributed.collectives`' (through pinned host memory
for gloo on the card); each op whose backward moves bytes keeps the
``record_transport()`` list and the obs trace of its forward
(``collectives.forward_scopes``) and records into them
(``collectives.transport_scope``), on whatever thread autograd runs it.

**Where the layout is not kept sharded**, each counted under the counter
``shard.redistribute_bytes`` (the bytes that reach this rank over the
non-DP axes) with an obs event ``shard.redistribute`` naming the op:

1. the leaves gathered whole over "model" by the hooks (``<path>
   parameters``, ``model parameters``): the moe's ``router`` (d, E),
   whose softmax and top-k read every expert's logit (a d x E leaf; the
   moe's only redistribution over "model");
2. where a consumer needs whole features, a column-parallel output
   gathered over "model" (:class:`_TPGather`): q, k and v where the q
   heads do not divide the axis (hymba's 25; ``attention wq output``
   ...), then ``attention wo input`` cut back for the row-parallel
   ``wo`` (:class:`_TPScatter`, whose backward gathers); mamba's
   ``in_proj`` output and ``out_proj``'s input where its SSM heads do
   not divide the axis (the production meshes, whose 16 divides neither
   hymba's 50 nor mamba2-130m's 24: the conv, the scan and the gated
   norm then run every head); where they divide, mamba runs by head
   (``models/mamba2.py``) and gathers only its heads' ``in_proj``
   columns, from ``in_proj`` (``mamba in_proj columns``) or from its
   output (``mamba in_proj output``: decode's one token, which forms
   the whole conv tail), whichever moves fewer bytes, each rank's
   gradient summed back by a reduce-scatter; ``frontend_proj``'s output;
   the kv heads' columns where the q heads divide and the kv heads do
   not (``attention wk columns``: the same reduce-scatter back);
   prefill's k and v for its caches, which hold every head, and decode's
   where the cache's sequence is whole;
3. decode: the logits gathered over the vocabulary (``decode logits``);
   no cache leaf is gathered under :func:`cache_specs` (a k / v leaf
   split over "model" is split along its sequence, the SSM ``state``
   along its heads, and each stays this rank's block: ``decode caches``
   counts a leaf placed otherwise);
4. an 8-bit moment's update, which gathers its parameter, gradient and
   codes (``8-bit moment <path>``).

The DP-axis gathers and reduce-scatters are ZeRO's own traffic, counted
under ``collective.bytes``, as are the moe FFN's sums over the DP ranks,
its exchange of capacity slots over them (``shard.expert_exchange_bytes``
counts it on its own, with an obs event ``shard.expert_exchange``) and
TP's own all-reduces over "model" (row-parallel outputs,
column-parallel inputs' gradients, the vocab-parallel reductions, a whole
leaf's gradient where each rank picks its own entries of it), which
``shard.tp_all_reduce_bytes`` also counts on their own. Where a dim
does not divide its axis the spec leaves it whole and the module runs
the product whole: no error is caught to fall back anywhere.

**Decode** (:func:`decode_step`) runs on the caches at
:func:`cache_specs`' placements without gathering a k / v leaf whose
sequence the spec splits over "model" (``k v cross_k cross_v``, where S
divides the axis): the model gets this rank's block, marked with a
:class:`SeqSplit` (``layers.mark_seq_split``), and attention's decode
runs flash-decoding on it, as the reference's
``sharded_decode_attention`` does: the new token's k and v (every kv
head, gathered over "model": ``decode kv token``) are written in place
only by the rank whose block holds the slot (``cache_index % S``, a
ring of ``min(S, window)`` slots on windowed layers, at
``slot // S_local``); q of every head of the rank's DP rows (gathered
over "model" where TP split the heads: ``decode q``) runs the partial
softmax over the block at global positions ``index * S_local +
arange(S_local)`` below ``kv_len``, and the partials are combined over
"model" (MAX, then the rescaled SUMs of l and o: ``decode combine``; a
rank whose block is wholly past ``kv_len`` adds 0). Each is counted
under ``collective.bytes`` and ``shard.decode_bytes`` with an obs event
``shard.decode``. Where the rank runs its own q heads it keeps their
rows of the result for the row-parallel ``wo``. The SSM ``state``,
split over "model" by heads where they divide (the debug meshes only),
stays this rank's head block too, marked with a :class:`TPSplit`
(``layers.mark_head_split``): mamba's decode gathers its ``in_proj``
output of the one token (every rank forms the whole conv tail, which
the specs leave whole) and runs the conv, the state update, the gated
norm and ``out_proj`` on its heads, updating the block in place. The
other leaves take the spec's own degrade rule, as the reference's: a
k / v leaf whose S does not divide "model", and every k / v leaf under
``seq_shard=False``, stays whole over "model" and decodes as before.

:func:`make_shard_fn` is the models' ``shard_fn(x, name)`` hook (a
:class:`ShardFn`). The port's activations are each rank's rows already
(the batch reaches the model as this rank's shard), so the
``"residual"`` constraint holds by construction and the hook returns
``x``; ``model_axis_residual`` (d over ``"model"``) would split the
residual stream that every rank of a model group holds whole between the
blocks, and raises where it would apply. The hook also tells the model
axis's size and this rank's index on it (``model_size``,
``model_index``), and answers the moe FFN, whose flat dispatch must see
the global batch as the reference's does: ``row_shares`` (the DP size
where the rows are split over it, else 1) scales the token count that
sets the capacity, ``"dp_sum"`` sums the router's statistics over the DP
ranks (its backward sums the gradients back), ``"dp_cumsum"`` gives
each expert's count up to and including this rank's rows, so an
assignment keeps the slot its global position gives it, ``"slot_window"``
sums the DP ranks' (E', slots, d) buffers and keeps this rank's window of
the slots (a reduce-scatter over the DP axes, one after another in mesh
order; :class:`_SlotWindow`) and ``"slot_gather"`` is its inverse (an
all-gather). The identity hook of one device is each of them with one
share.

The model's own entry points stay mesh-agnostic: :func:`shard_model`
hooks the blocks and the root module, so ``model_zoo.forward`` runs a
sharded model as it runs a plain one; prefill and decode on a mesh are
:func:`prefill` and :func:`decode_step` here, ``model_zoo``'s
counterparts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch import obs as _obs
from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import narrow_spans
from repro_torch.obs import counters as _counters
from repro_torch._state import _Moment, named_parameters

DP_AXES = ("pod", "data")
TP_AXIS = "model"
STACKS = ("blocks", "enc_blocks", "dec_blocks")


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name, or a tuple of axis names (sharded over all, major first);
    a one-name tuple is kept as the name, as jax's ``PartitionSpec``
    keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or of a plain mapping, in mesh order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in DP_AXES if a in axes)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def dp_size(mesh) -> int:
    """The product of the DP axes' sizes."""
    return _axsize(mesh, batch_axes(mesh))


def _fits(dim: int, mesh, axes) -> bool:
    s = _axsize(mesh, axes)
    return s > 1 and dim % s == 0


_COL = ("wq", "wk", "wv", "w_in", "w_gate", "in_proj", "router")
_ROW = ("wo", "w_out", "out_proj")


def _rule_for(path: str, shape, mesh) -> List:
    """The TP spec of a leaf (one layer's, in the port)."""
    name = path.split("/")[-1]
    nd = len(shape)
    if name == "table":                                   # embedding (V, d)
        return ["model" if _fits(shape[0], mesh, "model") else None, None]
    if name == "head" or path.endswith("head"):           # (d, V)
        return [None, "model" if _fits(shape[1], mesh, "model") else None]
    if name in ("w_in", "w_gate", "w_out") and nd == 3:   # MoE (E, ., .)
        return ["model" if _fits(shape[0], mesh, "model") else None,
                None, None]
    if name in _COL and nd == 2:
        return [None, "model" if _fits(shape[1], mesh, "model") else None]
    if name in _ROW and nd == 2:
        return ["model" if _fits(shape[0], mesh, "model") else None, None]
    if name == "frontend_proj":
        return [None, "model" if _fits(shape[1], mesh, "model") else None]
    return [None] * nd


def param_spec(path: str, leaf, mesh, fsdp: bool = True) -> P:
    """The spec of the parameter at ``path`` (module path, ``/``
    separators) of shape ``leaf.shape`` (or ``leaf`` itself, a shape)."""
    shape = tuple(getattr(leaf, "shape", leaf))
    spec = _rule_for(path, shape, mesh)
    if fsdp:
        dp = batch_axes(mesh)
        if dp:
            # ZeRO: shard the largest still-replicated dim over DP
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if spec[i] is None and _fits(shape[i], mesh, dp):
                    spec[i] = dp
                    break
    return P(*spec)


def named_shapes(params) -> Dict[str, tuple]:
    """{module path: shape} of a module (its parameters, registration
    order) or of a mapping of path -> tensor / shape."""
    if isinstance(params, nn.Module):
        params = named_parameters(params)
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def params_specs(params, mesh, fsdp: bool = True) -> Dict[str, P]:
    """{module path: spec} of a module's parameters (or of a mapping of
    path -> tensor / shape)."""
    return {k: param_spec(k, s, mesh, fsdp=fsdp)
            for k, s in named_shapes(params).items()}


def _moment_spec(m, ps: P, mesh):
    if isinstance(m, _Moment):                 # 8-bit: codes' block dim
        dp = batch_axes(mesh)
        qdim = m.q.shape[0]
        return _Moment(P(dp if dp and _fits(qdim, mesh, dp) else None, None),
                       P(None, None))
    return ps


def state_specs(state, mesh, fsdp: bool = True) -> dict:
    """Specs for the train state ``{"params": model, "opt": {"step", "m",
    "v"}}``: the parameters', the moments' (f32: the parameter's; 8-bit:
    :class:`_Moment` of the codes' and the scales' specs) and ``P()`` for
    the step."""
    pspecs = params_specs(state["params"], mesh, fsdp=fsdp)
    opt = state["opt"]
    return {"params": pspecs,
            "opt": {"step": P(),
                    "m": {k: _moment_spec(m, pspecs[k], mesh)
                          for k, m in opt["m"].items()},
                    "v": {k: _moment_spec(v, pspecs[k], mesh)
                          for k, v in opt["v"].items()}}}


def batch_specs(batch_shapes, mesh, accum: int = 1):
    """Input specs: tokens (B, S), or (accum, B / accum, S) with ``accum``
    > 1, batch over the DP axes where it divides. ``batch_shapes`` maps
    names to tensors or shapes."""
    dp = batch_axes(mesh)

    def spec_of(shape):
        nd = len(shape)
        bdim = 1 if accum > 1 else 0
        sb = dp if dp and shape[bdim] % _axsize(mesh, dp) == 0 else None
        spec = [None] * nd
        spec[bdim] = sb
        return P(*spec)

    return {k: spec_of(tuple(getattr(v, "shape", v)))
            for k, v in batch_shapes.items()}


# the unstacked rank of each cache leaf; a leading layer dim may precede it
_CACHE_RANK = {"k": 4, "v": 4, "cross_k": 4, "cross_v": 4, "state": 4,
               "conv": 3}
# the cache leaves whose sequence cache_specs splits over "model"
SEQ_LEAVES = ("k", "v", "cross_k", "cross_v")


def _cache_leaf_spec(name: str, shape, mesh, seq_shard: bool) -> P:
    dp = batch_axes(mesh)
    nd = len(shape)
    spec = [None] * nd
    br = _CACHE_RANK.get(name)
    if br is None or nd < br:
        return P(*spec)
    off = nd - br
    if dp and shape[off] % _axsize(mesh, dp) == 0:
        spec[off] = dp
    if name in SEQ_LEAVES:                                   # (B, S, H, hd)
        if seq_shard and _fits(shape[off + 1], mesh, "model"):
            spec[off + 1] = "model"
    if name == "state":                                      # (B, H, P, N)
        if _fits(shape[off + 1], mesh, "model"):
            spec[off + 1] = "model"
    return P(*spec)


def cache_specs(caches, mesh, seq_shard: bool = True):
    """Decode-cache specs, the same structure as ``caches`` (mappings and
    lists of tensors): batch over DP; the sequence of ``k v cross_k
    cross_v`` over ``"model"`` (flash-decoding's split) and the SSM
    ``state`` heads over ``"model"``, each where it divides."""
    def walk(tree, name):
        if isinstance(tree, Mapping):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return _cache_leaf_spec(name, tuple(tree.shape), mesh, seq_shard)
    return walk(caches, "")


class ShardFn:
    """The models' ``shard_fn(x, name)`` hook on ``mesh`` (module
    docstring). ``split_rows``: the activations' rows are this rank's
    share of the batch over the DP axes (else every rank holds them
    all)."""

    def __init__(self, mesh, model_axis_residual: bool = False,
                 split_rows: bool = True):
        self.mesh = mesh
        self.model_axis_residual = model_axis_residual
        self.split_rows = split_rows

    @property
    def row_shares(self) -> int:
        """Into how many equal shares the batch's rows are split."""
        return dp_size(self.mesh) if self.split_rows else 1

    def rows(self, split: bool) -> "ShardFn":
        return ShardFn(self.mesh, self.model_axis_residual, split)

    @property
    def model_size(self) -> int:
        """The size of the mesh's "model" axis (1 without one)."""
        return mesh_axes(self.mesh).get(TP_AXIS, 1)

    @property
    def model_index(self) -> int:
        """This rank's index on the "model" axis (0 without one)."""
        if self.model_size == 1:
            return 0
        return _model_axis(self.mesh)[1]

    def __call__(self, x, name):
        if name == "residual":
            if (self.model_axis_residual and x.ndim >= 2
                    and _fits(x.shape[-1], self.mesh, "model")):
                raise ValueError(
                    "model_axis_residual: the port keeps the residual stream "
                    "whole on every rank of a model group (TP inside the "
                    "blocks, ZeRO-3 over the DP axes: repro_torch."
                    "distributed.sharding), so it cannot stay split over "
                    "'model' between blocks")
            return x
        if self.row_shares == 1:
            return x
        if name == "dp_sum":
            return _DPSum.apply(x, self.mesh)
        if name == "dp_cumsum":
            return dp_cumsum(x, self.mesh)
        if name == "slot_window":
            return _SlotWindow.apply(x, self.mesh)
        if name == "slot_gather":
            return _SlotGather.apply(x, self.mesh)
        return x


def make_shard_fn(mesh, model_axis_residual: bool = False) -> ShardFn:
    """The models' ``shard_fn(x, name)`` hook for ``mesh``, the rows split
    over the DP axes (:class:`ShardFn`)."""
    return ShardFn(mesh, model_axis_residual)


def rows_split(tokens, mesh) -> bool:
    """Are a batch leaf's rows split over the DP axes (a DTensor at
    :func:`batch_specs`' placements whose batch divides), or does every
    rank hold them all?"""
    return isinstance(tokens, DTensor) and any(
        isinstance(pl, Shard) and name in DP_AXES and int(size) > 1
        for pl, name, size in zip(tokens.placements, mesh.mesh_dim_names,
                                  mesh.shape))


def rows_hook(shard_fn, split: bool):
    """``shard_fn`` for a forward whose rows are split over the DP axes
    (``split``) or whole on every rank: a :class:`ShardFn` told which;
    another callable as it is."""
    return shard_fn.rows(split) if isinstance(shard_fn, ShardFn) else shard_fn


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a DeviceMesh (jax's ``NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


def spec_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims."""
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {names}")
        for d in dims:
            if out[d] != Replicate():
                raise ValueError(f"mesh axis {names[d]!r} shards two dims "
                                 f"in {spec!r}")
            out[d] = Shard(i)
    return tuple(out)


def to_shardings(specs, mesh):
    """The tree of :class:`NamedSharding` of a tree of specs (mappings and
    :class:`_Moment` pairs of :class:`P`)."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, _Moment):
        return _Moment(*(to_shardings(s, mesh) for s in specs))
    if isinstance(specs, Mapping):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(to_shardings(v, mesh) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def mesh_device(mesh) -> torch.device:
    """Where a mesh's shards live: its device type (the current card for
    "cuda")."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coordinate(mesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} holds no coordinate in the "
                         f"mesh {mesh_axes(mesh)}")
    return list(coord)


def local_index(shape, placements, mesh) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``:
    the slices per dim (a dim sharded over several mesh dims splits over
    them row-major, the first mesh dim major)."""
    coord = _coordinate(mesh)
    sizes = list(int(s) for s in mesh.shape)
    idx, parts = [0] * len(shape), [1] * len(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            idx[pl.dim] = idx[pl.dim] * sizes[m] + coord[m]
            parts[pl.dim] *= sizes[m]
    out = []
    for n, i, k in zip(shape, idx, parts):
        if n % k:
            raise ValueError(f"dim {n} of {tuple(shape)} does not divide "
                             f"over {k} ranks ({placements})")
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def _wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def wrap(block: torch.Tensor, sharding, shape) -> DTensor:
    """This rank's ``block`` of a tensor of ``shape`` at ``sharding``, as
    a DTensor on the mesh's device."""
    return _wrap(block.to(mesh_device(sharding.mesh)), sharding.mesh,
                 sharding.placements, shape)


def distribute(full: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``full`` (the same on every rank) as a DTensor at ``sharding``: this
    rank keeps a copy of its block, on the mesh's device."""
    return _distribute(full, sharding.mesh, sharding.placements)


def _distribute(full: torch.Tensor, mesh, pl) -> DTensor:
    block = full.detach()[local_index(full.shape, pl, mesh)]
    local = block.to(mesh_device(mesh), copy=True,
                     memory_format=torch.contiguous_format)
    return _wrap(local, mesh, pl, full.shape)


def local(t):
    """A DTensor's local shard (its storage, under ``no_grad``); any other
    value as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _count(axis_bytes: Dict[str, int], what: str) -> None:
    """Count gathered bytes: DP axes under ``collective.bytes``, the rest
    under ``shard.redistribute_bytes`` with an obs event naming ``what``."""
    dp = sum(b for a, b in axis_bytes.items() if a in DP_AXES)
    other = sum(b for a, b in axis_bytes.items() if a not in DP_AXES)
    if dp:
        _counters.inc("collective.bytes", dp)
    if other:
        _counters.inc("shard.redistribute_bytes", other)
        if _obs.enabled():
            _obs.event("shard.redistribute", cat="collective", op=what,
                       bytes=other, axes=sorted(a for a in axis_bytes
                                                if a not in DP_AXES))


def _gather(t: DTensor, axis_bytes: Dict[str, int],
            keep=()) -> torch.Tensor:
    """The full tensor of ``t``: its shards all-gathered over each mesh
    dim that shards it, innermost first, but the axes in ``keep``; the
    bytes that reached this rank are added to ``axis_bytes`` per axis.
    Not recorded by autograd (:class:`_Gather` is)."""
    with torch.no_grad():
        mesh, out = t.device_mesh, t.to_local()
    names = mesh.mesh_dim_names
    for m in reversed(range(len(t.placements))):
        pl = t.placements[m]
        if isinstance(pl, Shard) and names[m] not in keep:
            size = int(mesh.shape[m])
            axis_bytes[names[m]] = axis_bytes.get(names[m], 0) + (
                size - 1) * out.numel() * out.element_size()
            out = coll.all_gather_cat(out, mesh, names[m], pl.dim)
    return out


def full_tensor(t, what: Optional[str] = None) -> torch.Tensor:
    """A DTensor's full value on every rank (a collective over its mesh),
    counted as :func:`_count` counts under the op ``what`` where one is
    named (a checkpoint's or a re-placement's gather is not a step's);
    any other tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    axis_bytes: Dict[str, int] = {}
    out = _gather(t, axis_bytes)
    if what is not None:
        _count(axis_bytes, what)
    return out


def shard_grad(g: torch.Tensor, mesh, placements, shape,
               local=()) -> DTensor:
    """A gradient from this rank's rows -> the mean over the DP axes, at
    ``placements``: first cut to this rank's block over the other axes
    (the gradient of a leaf gathered whole over them is the same on each
    of their ranks, so no bytes move), where those shard a tensor dim of
    their own, but the axes in ``local`` (a TP leaf's gradient is this
    rank's block already); then reduce-scattered (or, where the parameter
    is replicated over a DP axis, all-reduced) over the DP axes and
    divided by their size."""
    names = mesh.mesh_dim_names
    coord = _coordinate(mesh)
    dp_dims = {pl.dim for m, pl in enumerate(placements)
               if isinstance(pl, Shard) and names[m] in DP_AXES}
    first = [m for m, pl in enumerate(placements) if names[m] not in DP_AXES
             and names[m] not in local and isinstance(pl, Shard)
             and pl.dim not in dp_dims]
    out, ndp = g, 1
    for m in first + [m for m in range(len(placements)) if m not in first]:
        pl, axis, size = placements[m], names[m], int(mesh.shape[m])
        if size == 1 or axis in local:
            continue
        if axis in DP_AXES:
            ndp *= size
            # bytes that reach this rank: the other ranks' partial chunks
            # (a ring all-reduce is a reduce-scatter and an all-gather)
            chunk = out.numel() * out.element_size() // size
            if isinstance(pl, Shard):
                out = coll.reduce_scatter_chunk(out, mesh, axis, pl.dim)
                _counters.inc("collective.bytes", (size - 1) * chunk)
            else:
                out = coll.all_reduce(out, mesh, axis, dist.ReduceOp.SUM)
                _counters.inc("collective.bytes", 2 * (size - 1) * chunk)
        elif isinstance(pl, Shard):
            out = out.chunk(size, pl.dim)[coord[m]]
    if ndp > 1:
        out = out / ndp
    return _wrap(out.contiguous(), mesh, placements, shape)


class _Gather(torch.autograd.Function):
    """The value of a DTensor parameter for the forward, gathered over
    every mesh axis but those in ``keep`` (whose blocks stay local); its
    gradient back to the parameter's placements (:func:`shard_grad`, the
    ``keep`` axes' gradient already this rank's block)."""

    @staticmethod
    def forward(ctx, p, axis_bytes, keep=()):
        ctx.mesh, ctx.placements, ctx.shape = (p.device_mesh, p.placements,
                                               p.shape)
        ctx.keep, ctx.rec = keep, coll.forward_scopes()
        return _gather(p, axis_bytes, keep)

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return shard_grad(g, ctx.mesh, ctx.placements, ctx.shape,
                              local=ctx.keep), None, None


# ---------------------------------------------------------------------------
# tensor parallelism over "model": the ops a module runs on its kept blocks
# ---------------------------------------------------------------------------

def _model_axis(mesh) -> Tuple[int, int]:
    """(size, this rank's index) of the mesh's "model" axis."""
    _, size, idx = coll.axis_group(mesh, TP_AXIS)
    return size, idx


def _tp_all_reduce(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM):
    """``x`` reduced over "model", counted under ``collective.bytes`` as
    :func:`shard_grad` counts an all-reduce, and again under
    ``shard.tp_all_reduce_bytes`` (TP's share of them)."""
    n, _ = _model_axis(mesh)
    moved = 2 * (n - 1) * x.numel() * x.element_size() // n
    _counters.inc("collective.bytes", moved)
    _counters.inc("shard.tp_all_reduce_bytes", moved)
    return coll.all_reduce(x.contiguous(), mesh, TP_AXIS, op)


def _tp_all_gather(x: torch.Tensor, mesh, dim: int, what: str):
    """The blocks of ``x`` over "model" concatenated along ``dim``, counted
    as a redistribution named ``what``."""
    n, _ = _model_axis(mesh)
    _count({TP_AXIS: (n - 1) * x.numel() * x.element_size()}, what)
    return coll.all_gather_cat(x.contiguous(), mesh, TP_AXIS, dim)


class _TPCopy(torch.autograd.Function):
    """A column-parallel product's input: the identity forward; the
    gradient (each rank's from its columns) summed over "model"."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rec = mesh, coll.forward_scopes()
        return x

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return _tp_all_reduce(g, ctx.mesh), None


class _TPReduce(torch.autograd.Function):
    """A row-parallel product's partial output summed over "model"; the
    gradient (the same on every rank) passed through."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _tp_all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPGather(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim`` and the other ranks' of the
    "model" axis, concatenated. The gradient: this rank's block of it
    where the consumer runs the same on every rank, or (``partial``: each
    rank's consumer reads part of it) summed over "model" first, a
    reduce-scatter. Both directions counted under ``what``."""

    @staticmethod
    def forward(ctx, x, mesh, dim, what, partial):
        ctx.mesh, ctx.dim, ctx.what, ctx.partial = mesh, dim, what, partial
        ctx.rec = coll.forward_scopes()
        return _tp_all_gather(x, mesh, dim, what)

    @staticmethod
    def backward(ctx, g):
        n, idx = _model_axis(ctx.mesh)
        if not ctx.partial:
            return g.chunk(n, ctx.dim)[idx], None, None, None, None
        with coll.transport_scope(ctx.rec):
            _count({TP_AXIS: (n - 1) * g.numel() * g.element_size() // n},
                   ctx.what)
            out = coll.reduce_scatter_chunk(g.contiguous(), ctx.mesh,
                                            TP_AXIS, ctx.dim)
        return out, None, None, None, None


class _TPScatter(torch.autograd.Function):
    """This rank's block along ``dim`` of an activation every rank of the
    "model" axis holds whole (a row-parallel product's input); the
    gradient's blocks gathered back, counted under ``what``."""

    @staticmethod
    def forward(ctx, x, mesh, dim, what):
        ctx.mesh, ctx.dim, ctx.what = mesh, dim, what
        ctx.rec = coll.forward_scopes()
        n, idx = _model_axis(mesh)
        return x.chunk(n, dim)[idx]

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return _tp_all_gather(g, ctx.mesh, ctx.dim, ctx.what), None, \
                None, None


class _TPPick(torch.autograd.Function):
    """Entries ``spans`` ([start, stop) pairs, concatenated) along ``dim``
    of a leaf every rank of the "model" axis holds whole, where each rank
    reads its own entries; the gradient, zero outside them, summed over
    "model" (one all-reduce of the whole leaf)."""

    @staticmethod
    def forward(ctx, w, mesh, dim, spans):
        ctx.mesh, ctx.dim, ctx.spans, ctx.shape = mesh, dim, spans, w.shape
        ctx.rec = coll.forward_scopes()
        return narrow_spans(w, dim, spans)

    @staticmethod
    def backward(ctx, g):
        full, at = g.new_zeros(ctx.shape), 0
        for a, b in ctx.spans:
            full.narrow(ctx.dim, a, b - a).copy_(g.narrow(ctx.dim, at, b - a))
            at += b - a
        with coll.transport_scope(ctx.rec):
            return _tp_all_reduce(full, ctx.mesh), None, None, None


@dataclasses.dataclass(frozen=True)
class TPSplit:
    """A parameter kept as this rank's block over "model" (its dim
    ``dim`` split in ``size`` blocks, this rank's the ``index``-th) for
    the products of the module that owns it, and the "model" axis's ops
    the module runs around them (module docstring, "Compute"). The
    models read it with ``layers.tp_split(module, name)``."""

    mesh: object
    dim: int
    size: int
    index: int

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's [start, stop) of ``n`` entries split in ``size``
        blocks."""
        return self.index * n // self.size, (self.index + 1) * n // self.size

    def copy(self, x):
        """A column-parallel product's input (gradient summed)."""
        return _TPCopy.apply(x, self.mesh)

    def reduce(self, x):
        """Partial results summed over "model" (gradient passed through)."""
        return _TPReduce.apply(x, self.mesh)

    def max(self, x):
        """The maximum over "model" (not recorded by autograd)."""
        with torch.no_grad():
            return _tp_all_reduce(x, self.mesh, dist.ReduceOp.MAX)

    def gather(self, x, what: str, dim: int = -1, partial: bool = False):
        """Every rank's block of ``x`` along ``dim``, concatenated
        (:class:`_TPGather`, counted under ``what``)."""
        return _TPGather.apply(x, self.mesh, dim % x.ndim, what, partial)

    def scatter(self, x, what: str, dim: int = -1):
        """This rank's block of a whole activation (:class:`_TPScatter`)."""
        return _TPScatter.apply(x, self.mesh, dim % x.ndim, what)

    def pick(self, w, dim: int, start: int, stop: int):
        """Entries [start, stop) of a whole leaf (:class:`_TPPick`)."""
        return self.pick_spans(w, dim, ((start, stop),))

    def pick_spans(self, w, dim: int, spans):
        """Entries ``spans`` ([start, stop) pairs, concatenated) of a whole
        leaf (:class:`_TPPick`)."""
        return _TPPick.apply(w, self.mesh, dim, tuple(spans))


def _tp_dim(p: DTensor) -> Optional[int]:
    """The tensor dim a DTensor shards over a "model" axis of more than
    one rank, or None."""
    names = p.device_mesh.mesh_dim_names
    for m, pl in enumerate(p.placements):
        if isinstance(pl, Shard) and names[m] == TP_AXIS \
                and int(p.device_mesh.shape[m]) > 1:
            return pl.dim
    return None


# ---------------------------------------------------------------------------
# the model on a mesh: parameters as DTensors, gathered per block
# ---------------------------------------------------------------------------

def _owners(module: nn.Module):
    """(owner module, attribute name) of each parameter."""
    return [(mod, name) for mod in module.modules()
            for name, p in mod._parameters.items() if p is not None]


def _block_modules(model: nn.Module):
    """(path, block) of every layer of the model's layer stacks."""
    for name in STACKS:
        stack = getattr(model, name, None)
        if isinstance(stack, nn.ModuleList):
            for i, blk in enumerate(stack):
                yield f"{name}/{i}", blk


def _swap_in(params, what: str) -> list:
    """Replace each DTensor parameter of ``params`` ((owner, name) pairs)
    by its value for the forward (recorded for autograd while grad mode
    is on); returns what to put back. Counted as one ``what``. A leaf
    split over "model" whose owner lists it in its ``TP_LEAVES`` stays
    this rank's block (gathered over the DP axes only), and the owner's
    ``_tp_leaves`` maps its name to a :class:`TPSplit`; every other leaf
    is gathered whole."""
    swapped, axis_bytes = [], {}
    for owner, name in params:
        p = owner._parameters[name]
        if isinstance(p, DTensor):
            dim = _tp_dim(p) if name in getattr(owner, "TP_LEAVES",
                                                ()) else None
            keep = () if dim is None else (TP_AXIS,)
            if torch.is_grad_enabled() and p.requires_grad:
                full = _Gather.apply(p, axis_bytes, keep)
            else:
                full = _gather(p, axis_bytes, keep)
            owner._parameters[name] = full
            if dim is not None:
                size, idx = _model_axis(p.device_mesh)
                owner.__dict__.setdefault("_tp_leaves", {})[name] = TPSplit(
                    p.device_mesh, dim, size, idx)
            swapped.append((owner, name, p))
    _count(axis_bytes, what)
    return swapped


def _swap_out(swapped) -> None:
    for owner, name, p in swapped:
        owner._parameters[name] = p
        owner.__dict__.get("_tp_leaves", {}).pop(name, None)


def _hook_block(path: str, blk: nn.Module) -> None:
    """FSDP's unshard around a block's forward: its parameters gathered
    (the TP leaves over the DP axes only) when it starts, again when
    remat recomputes it, put back when it returns."""
    if getattr(blk, "_repro_shard_hooks", False):
        return
    params = _owners(blk)
    stack: List[list] = []

    def pre(module, args):
        stack.append(_swap_in(params, f"{path} parameters"))

    def post(module, args, output):
        _swap_out(stack.pop())

    blk.register_forward_pre_hook(pre)
    blk.register_forward_hook(post, always_call=True)
    blk._repro_shard_hooks = True


def model_mesh(model: nn.Module):
    """The mesh of a model's DTensor parameters, or None (one device)."""
    for p in model.parameters():
        if isinstance(p, DTensor):
            return p.device_mesh
    return None


def set_param(model: nn.Module, path: str, value: torch.Tensor) -> None:
    """Replace the parameter at ``path`` by ``value`` (a DTensor or a
    tensor), keeping its ``requires_grad``."""
    *mods, name = path.split("/")
    owner = model
    for m in mods:
        owner = getattr(owner, m)
    old = owner._parameters[name]
    owner._parameters[name] = nn.Parameter(value, requires_grad=bool(
        old is not None and old.requires_grad))


def _outside_blocks(model: nn.Module):
    """(owner, name) of the parameters outside the layer stacks."""
    inner = {id(m) for _, b in _block_modules(model) for m in b.modules()}
    return [(o, n) for o, n in _owners(model) if id(o) not in inner]


def _hook_root(model: nn.Module) -> None:
    """The parameters outside the layer stacks gathered for the model's
    whole forward (the blocks gather their own)."""
    if getattr(model, "_repro_shard_hooks", False):
        return
    params = _outside_blocks(model)
    stack: List[list] = []

    def pre(module, args):
        stack.append(_swap_in(params, "model parameters"))

    def post(module, args, output):
        _swap_out(stack.pop())

    model.register_forward_pre_hook(pre)
    model.register_forward_hook(post, always_call=True)
    model._repro_shard_hooks = True


def hook_model(model: nn.Module) -> None:
    """Hook the blocks and the root of a model whose parameters are
    DTensors (:func:`shard_model` does it; a model filled with DTensors
    otherwise, as a restore fills it, calls it itself)."""
    for path, blk in _block_modules(model):
        _hook_block(path, blk)
    _hook_root(model)


def shard_model(model: nn.Module, mesh, specs=None,
                fsdp: bool = True) -> nn.Module:
    """Put every parameter of ``model`` (the same values on every rank) on
    ``mesh`` at ``specs`` (default :func:`params_specs`), in place, and
    hook its blocks and its root, so that its forward runs on this rank's
    rows as a plain model's does; with ``mesh=None``, gather them back to
    plain tensors (one device)."""
    if mesh is None:
        for path, p in list(named_parameters(model).items()):
            set_param(model, path, full_tensor(p).detach().clone())
        return model
    specs = params_specs(model, mesh, fsdp=fsdp) if specs is None else specs
    for path, p in list(named_parameters(model).items()):
        set_param(model, path, distribute(full_tensor(p),
                                          NamedSharding(mesh, specs[path])))
    hook_model(model)
    return model


@contextlib.contextmanager
def _swapped(params, what: str) -> Iterator[None]:
    """Within the scope ``params`` ((owner, name) pairs) hold their values
    for the forward, as the hooks swap them in, for the methods that
    bypass the modules' hooks (:func:`prefill`, :func:`decode_step`)."""
    swapped = _swap_in(params, what)
    try:
        yield
    finally:
        _swap_out(swapped)


# ---------------------------------------------------------------------------
# the train state on a mesh
# ---------------------------------------------------------------------------

def _place_moment(m, shardings, mesh):
    if mesh is None:
        if isinstance(m, _Moment):
            return _Moment(*(full_tensor(t) for t in m))
        return full_tensor(m)
    if isinstance(m, _Moment):
        return _Moment(*(distribute(full_tensor(t), s)
                         for t, s in zip(m, shardings)))
    return distribute(full_tensor(m), shardings)


def place_state(state: dict, mesh, fsdp: bool = True) -> dict:
    """The train state on ``mesh`` at :func:`state_specs` (the model's
    parameters replaced in place), from a state that every rank holds
    whole or from one on another mesh; ``mesh=None`` gathers it back to
    one device."""
    model = state["params"]
    if mesh is None:
        shard_model(model, None)
        sh = None
    else:
        sh = to_shardings(state_specs(state_shapes(state), mesh, fsdp),
                          mesh)
        shard_model(model, mesh, {k: s.spec for k, s in sh["params"].items()})
    opt = state["opt"]
    new = {"step": _place_moment(opt["step"], sh and sh["opt"]["step"],
                                 mesh)}
    for mom in ("m", "v"):
        new[mom] = {k: _place_moment(v, sh and sh["opt"][mom][k], mesh)
                    for k, v in opt[mom].items()}
    return {"params": model, "opt": new}


def state_shapes(state: dict) -> dict:
    """The state's shapes as :func:`state_specs` reads them."""
    return {"params": named_shapes(state["params"]), "opt": state["opt"]}


def local_bytes(tree) -> int:
    """Bytes this rank holds of a state (its shards)."""
    if isinstance(tree, nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, Mapping):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    t = local(tree)
    return t.numel() * t.element_size()


def spec_bytes(state: dict, mesh, fsdp: bool = True) -> int:
    """Bytes one rank holds of ``state`` under :func:`state_specs`: each
    leaf's global bytes over the sizes of the axes its spec names."""
    specs = state_specs(state_shapes(state), mesh, fsdp)
    shapes = named_shapes(state["params"])
    total = 0

    def leaf(t, spec, shape=None, itemsize=None):
        shape = tuple(t.shape) if shape is None else shape
        itemsize = t.element_size() if itemsize is None else itemsize
        n = math.prod(shape) * itemsize
        return n // math.prod(_axsize(mesh, e) for e in spec)

    for k, spec in specs["params"].items():
        total += leaf(None, spec, shapes[k], 4)
    total += leaf(state["opt"]["step"], specs["opt"]["step"])
    for mom in ("m", "v"):
        for k, spec in specs["opt"][mom].items():
            m = state["opt"][mom][k]
            if isinstance(m, _Moment):
                total += sum(leaf(t, s) for t, s in zip(m, spec))
            else:
                total += leaf(m, spec)
    return total


# ---------------------------------------------------------------------------
# reductions over the mesh
# ---------------------------------------------------------------------------

def mesh_sum(t: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """``t`` summed over ``axes`` of ``mesh`` (every axis by default)."""
    for a in (mesh.mesh_dim_names if axes is None else axes):
        t = coll.all_reduce(t, mesh, a, dist.ReduceOp.SUM)
    return t


def _dp_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the DP axes, counted under ``collective.bytes``
    as :func:`shard_grad` counts an all-reduce."""
    n = dp_size(mesh)
    _counters.inc("collective.bytes",
                  2 * (n - 1) * x.numel() * x.element_size() // n)
    return mesh_sum(x, mesh, batch_axes(mesh))


class _DPSum(torch.autograd.Function):
    """``x`` summed over the DP axes; the gradient summed back over them
    (every rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rec = mesh, coll.forward_scopes()
        return _dp_all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return _dp_all_reduce(g.contiguous(), ctx.mesh), None


def _dp_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the DP axes, this rank's block of its dim 1 (the
    DP ranks' blocks in flat order: a reduce-scatter over each axis in
    mesh order), counted by :func:`_count_exchange`."""
    for a in batch_axes(mesh):
        x = coll.reduce_scatter_chunk(x.contiguous(), mesh, a, 1)
    _count_exchange(x, mesh, "slot_window")
    return x


def _dp_cat(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every DP rank's block ``x`` of dim 1, concatenated in flat order
    (the inverse of :func:`_dp_scatter`'s blocks), counted the same way."""
    _count_exchange(x, mesh, "slot_gather")
    for a in reversed(batch_axes(mesh)):
        x = coll.all_gather_cat(x.contiguous(), mesh, a, 1)
    return x


def _count_exchange(block: torch.Tensor, mesh, op: str) -> None:
    """The bytes an exchange of ``block``-sized windows brings this rank
    over the DP axes, (n - 1) of them, under ``collective.bytes`` and
    ``shard.expert_exchange_bytes``, with an obs event."""
    moved = (dp_size(mesh) - 1) * block.numel() * block.element_size()
    _counters.inc("collective.bytes", moved)
    _counters.inc("shard.expert_exchange_bytes", moved)
    if _obs.enabled():
        _obs.event("shard.expert_exchange", cat="collective", op=op,
                   bytes=moved, axes=list(batch_axes(mesh)))


class _SlotWindow(torch.autograd.Function):
    """The moe's capacity slots (E', slots, d), disjoint over the DP
    ranks, summed over them: this rank's window of every expert's slots
    (a reduce-scatter); the gradient, every window's, gathered back."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rec = mesh, coll.forward_scopes()
        return _dp_scatter(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return _dp_cat(g, ctx.mesh), None


class _SlotGather(torch.autograd.Function):
    """Every DP rank's window of the experts' outputs, gathered (the
    inverse of :class:`_SlotWindow`); the gradient summed over the DP
    ranks, this rank's window of it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rec = mesh, coll.forward_scopes()
        return _dp_cat(x, mesh)

    @staticmethod
    def backward(ctx, g):
        with coll.transport_scope(ctx.rec):
            return _dp_scatter(g, ctx.mesh), None


def dp_cumsum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over this rank and the DP ranks before it (the rows'
    order: :func:`dp_rows`), gathered over the DP axes (counted under
    ``collective.bytes``)."""
    dp = batch_axes(mesh)
    i, n = coll.flat_index(mesh, dp)
    _counters.inc("collective.bytes", (n - 1) * x.numel() * x.element_size())
    every = x[None]
    for a in reversed(dp):
        every = coll.all_gather_cat(every, mesh, a, 0)
    return every[:i + 1].sum(0)


def owned_sumsq(t) -> torch.Tensor:
    """The f32 sum of squares of a DTensor's shard where this rank owns it
    (coordinate 0 on every mesh dim that replicates it), else 0; summed
    over the mesh this is the full tensor's once. A plain tensor's own."""
    if not isinstance(t, DTensor):
        return torch.sum(torch.square(t.float()))
    s = torch.sum(torch.square(t.to_local().float()))
    coord = _coordinate(t.device_mesh)
    owner = all(c == 0 for c, pl in zip(coord, t.placements)
                if not isinstance(pl, Shard))
    return s if owner else torch.zeros_like(s)


def global_norm(leaves, mesh) -> torch.Tensor:
    """The f32 global norm of DTensor leaves on ``mesh``: each shard's
    squares counted once over the mesh (:func:`owned_sumsq`)."""
    return torch.sqrt(mesh_sum(sum(owned_sumsq(t) for t in leaves), mesh))


# the values of a gathered leaf an 8-bit moment's update runs at once (a
# kimi-k2 expert leaf holds 5.6e9: its whole update's f32 temporaries
# would take hundreds of GB)
UPDATE_CHUNK = 1 << 28


def update_leaf(fn, p: DTensor, g: DTensor, m, v, args, what: str):
    """A sharded leaf's optimizer update: ``fn(p, g, m, v, *args)`` (which
    writes ``p`` in place and returns the new (m, v)) on this rank's
    shards, f32 moments written in place. An 8-bit moment's blocks run
    over the whole parameter: the parameter, gradient and codes are
    gathered (counted under ``what``), ``fn`` runs on every rank over
    ``UPDATE_CHUNK`` values of the flattened leaf at a time (whole
    blocks: each block's codes and scale are its own, so the result is
    the whole leaf's), and each keeps its blocks."""
    if not isinstance(m, _Moment):
        fn(local(p), local(g), local(m), local(v), *args)
        return m, v
    full = lambda t: full_tensor(t, what)                    # noqa: E731
    pf = full(p).contiguous()
    flat_p, flat_g = pf.view(-1), full(g).reshape(-1)
    codes = [full(t) for t in (*m, *v)]                      # mq ms vq vs
    new = [torch.empty_like(t) for t in codes]
    block = codes[0].shape[-1]
    step = max(UPDATE_CHUNK // block, 1) * block
    for a in range(0, flat_p.numel(), step):
        b = min(a + step, flat_p.numel())
        blocks = slice(a // block, -(-b // block))
        nm, nv = fn(flat_p[a:b], flat_g[a:b], _Moment(*(
            t[blocks] for t in codes[:2])), _Moment(*(
                t[blocks] for t in codes[2:])), *args)
        for out, t in zip(new, (*nm, *nv)):
            out[blocks] = t
    local(p).copy_(pf[local_index(pf.shape, p.placements, p.device_mesh)])
    return (_Moment(*map(like, new[:2], m)),
            _Moment(*map(like, new[2:], v)))


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` reaches this point before any leaves it."""
    mesh_sum(torch.zeros(1, device=mesh_device(mesh)), mesh)


def dp_rows(n: int, mesh) -> slice:
    """This rank's rows of a batch of ``n`` under :func:`batch_specs`' rule
    (all of them where ``n`` does not divide the DP size)."""
    dp = batch_axes(mesh)
    ndp = _axsize(mesh, dp)
    if not dp or n % ndp:
        return slice(0, n)
    i, _ = coll.flat_index(mesh, dp)
    return slice(i * (n // ndp), (i + 1) * (n // ndp))


def gather_rows(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The inverse of :func:`dp_rows`: every rank's rows, all ranks."""
    dp = batch_axes(mesh)
    if not dp or n % _axsize(mesh, dp):
        return t
    for a in reversed(dp):
        t = coll.all_gather_cat(t, mesh, a, 0)
    return t


# ---------------------------------------------------------------------------
# decode on a mesh
# ---------------------------------------------------------------------------

def place_caches(caches, mesh, seq_shard: bool = True):
    """Decode caches (the same on every rank) as DTensors at
    :func:`cache_specs`' placements on ``mesh``."""
    leaves, tree = pytree.tree_flatten(caches)
    specs = pytree.tree_leaves(cache_specs(caches, mesh, seq_shard),
                               is_leaf=lambda x: isinstance(x, P))
    return pytree.tree_unflatten([distribute(t, NamedSharding(mesh, s))
                                  for t, s in zip(leaves, specs)], tree)


def tree_mesh(tree):
    """The mesh of the first DTensor among a tree's leaves, or None."""
    return next((t.device_mesh for t in pytree.tree_leaves(tree)
                 if isinstance(t, DTensor)), None)


def _nondp_cut(full: torch.Tensor, t: DTensor) -> torch.Tensor:
    """This rank's block of ``full`` over ``t``'s non-DP axes (the
    inverse of ``_gather(t, ..., keep=DP_AXES)``)."""
    coord = _coordinate(t.device_mesh)
    names = t.device_mesh.mesh_dim_names
    out = full
    for m, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and names[m] not in DP_AXES:
            out = out.chunk(int(t.device_mesh.shape[m]), pl.dim)[coord[m]]
    return out


def gather_logits(logits: torch.Tensor,
                  what: str = "logits") -> torch.Tensor:
    """Logits whole over the vocabulary: a vocab-parallel head's (this
    rank's columns, marked by ``layers.vocab_split``) gathered over
    "model", counted under ``what``; any other as they are."""
    from repro_torch.models.layers import vocab_split
    split = vocab_split(logits)
    return logits if split is None else split.gather(logits, what)


def prefill(model: nn.Module, batch: dict, cfg, shard_fn=None,
            use_kernels=None):
    """``model_zoo.prefill`` on a mesh: ``batch``'s leaves as DTensors at
    :func:`batch_specs` (each rank runs its rows) or whole on every rank;
    the model at :func:`shard_model`'s placements, its blocks swapped in
    by their hooks and the rest for the call, the products TP. Returns
    this rank's rows: the logits its vocabulary block where the head is
    split (:func:`gather_logits` makes them whole), the aux loss and the
    caches with every kv head (gathered over "model")."""
    from repro_torch.models import model_zoo
    mesh = model_mesh(model)
    hook = rows_hook(make_shard_fn(mesh) if shard_fn is None else shard_fn,
                     rows_split(batch["tokens"], mesh))
    rows = {k: local(v) for k, v in batch.items()}
    with _swapped(_outside_blocks(model), "model parameters"):
        return model_zoo.prefill(model, rows, cfg, shard_fn=hook,
                                 use_kernels=use_kernels)


def _count_decode(moved: int, what: str) -> None:
    """Count a decode op on sequence-split caches (``what``: ``decode q``,
    ``decode kv token``, ``decode combine``): the bytes that reach this
    rank over "model", under ``collective.bytes`` and
    ``shard.decode_bytes``, with an obs event ``shard.decode``."""
    _counters.inc("collective.bytes", moved)
    _counters.inc("shard.decode_bytes", moved)
    if _obs.enabled():
        _obs.event("shard.decode", cat="collective", op=what, bytes=moved,
                   axes=[TP_AXIS])


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A decode cache leaf held as this rank's block of its sequence over
    "model" (``size`` blocks, this rank's the ``index``-th), as
    :func:`decode_step` hands it to the model (``layers.mark_seq_split``),
    and the ops attention's decode runs on it (module docstring,
    "Decode")."""

    mesh: object
    size: int
    index: int

    def gather(self, x, what: str, dim: int = -1):
        """Every rank's block of ``x`` along ``dim``, concatenated in rank
        order (an all-gather over "model", counted under ``what``)."""
        _count_decode((self.size - 1) * x.numel() * x.element_size(), what)
        return coll.all_gather_cat(x.contiguous(), self.mesh, TP_AXIS,
                                   dim % x.ndim)

    def gatherer(self, what: str):
        """:meth:`gather` along the last dim, counted under ``what``."""
        return lambda x: self.gather(x, what)

    def write(self, cache, slot: int, x) -> None:
        """Write ``x`` (B, 1, ...) at slot ``slot`` of the whole sequence,
        in place, where this rank's block ``cache`` (B, Sc, ...) holds
        it; the other ranks write nothing."""
        sc = cache.shape[1]
        if slot // sc == self.index:
            at = slot % sc
            cache[:, at:at + 1] = x.to(cache.dtype)

    def attend(self, q, k, v, kv_len: int):
        """q (B, Hq, D) of every head against this rank's block k, v (B,
        Sc, Hkv, D) of a cache whose first ``kv_len`` slots are valid:
        flash-decoding, the partials combined over "model"
        (``collectives.block_decode_attention``, counted as ``decode
        combine``). Returns (B, Hq, D) in q's dtype."""
        b, hq, d = q.shape
        moved = sum(2 * (self.size - 1) * n * 4 // self.size
                    for n in (b * hq, b * hq, b * hq * d))     # m, l, o
        _count_decode(moved, "decode combine")
        lens = torch.full((b,), kv_len, dtype=torch.int64, device=q.device)
        return coll.block_decode_attention(
            q, k, v, self.index * k.shape[1], lens, self.mesh,
            TP_AXIS).to(q.dtype)


def _model_block_of(t: DTensor):
    """(size, this rank's index) of the "model" axis where ``t``'s
    placements split its dim ``ndim - 3`` over it (a k / v leaf's
    sequence, (..., B, S, Hkv, hd); the SSM state's heads, (..., B, H, P,
    N)), or None."""
    names = t.device_mesh.mesh_dim_names
    for m, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and names[m] == TP_AXIS \
                and pl.dim == t.ndim - 3 and int(t.device_mesh.shape[m]) > 1:
            return _model_axis(t.device_mesh)
    return None


def _decode_leaves(tree, axis_bytes: Dict[str, int], blocks: dict,
                   name: str = ""):
    """The caches as the model decodes on them: a k / v leaf whose
    sequence is split over "model" as a view of this rank's block, marked
    with a :class:`SeqSplit` (``layers.mark_seq_split``), and the SSM
    state whose heads are as a view of this rank's head block, marked
    with a :class:`TPSplit` (``layers.mark_head_split``; ``blocks`` maps
    each DTensor's id to its view); every other DTensor leaf gathered over
    its non-DP axes (counted into ``axis_bytes``); plain leaves as they
    are."""
    from repro_torch.models.layers import mark_head_split, mark_seq_split
    if isinstance(tree, Mapping):
        return {k: _decode_leaves(v, axis_bytes, blocks, str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_decode_leaves(v, axis_bytes, blocks, name)
                          for v in tree)
    if not isinstance(tree, DTensor):
        return tree
    split = _model_block_of(tree) if name in SEQ_LEAVES + ("state",) \
        else None
    if split is None:
        return _gather(tree, axis_bytes, keep=DP_AXES)
    with torch.no_grad():
        block = tree.to_local()
    view = block.view(block.shape)
    if name == "state":
        view = mark_head_split(view, TPSplit(tree.device_mesh, tree.ndim - 3,
                                             *split))
    else:
        view = mark_seq_split(view, SeqSplit(tree.device_mesh, *split))
    blocks[id(tree)] = view
    return view


@torch.no_grad()
def decode_step(model: nn.Module, token: torch.Tensor, cfg, caches,
                cache_index: int, shard_fn=None):
    """``model_zoo.decode_step`` on a mesh (the same arguments): every rank
    passes the whole token batch (B, 1), the model at :func:`shard_model`'s
    placements and the caches at :func:`place_caches`' (or plain caches,
    whole on every rank). The rank decodes its DP rows: the parameters
    swapped in (``model parameters``: the TP leaves this rank's blocks,
    the products TP). A k / v leaf whose sequence :func:`cache_specs`
    split over "model" stays this rank's block: the model writes the
    token into it where the block holds the slot, and attends on it by
    flash-decoding (:class:`SeqSplit`, module docstring, "Decode"). The
    SSM state whose heads it split stays this rank's head block, which
    mamba's decode updates on its own heads (a :class:`TPSplit` mark).
    Every other cache leaf is gathered over its non-DP axes (``decode
    caches``; none under :func:`cache_specs`, which splits no other leaf
    over "model") and its block written back after the step. The logits
    are gathered over the vocabulary and the rows, so every rank returns
    all (B, 1, V) of them. ``shard_fn``: the models' hook (default
    :func:`make_shard_fn`)."""
    mesh = model_mesh(model) or tree_mesh(caches)
    token = full_tensor(token)
    n = token.shape[0]
    ndp = dp_size(mesh)
    split = tree_mesh(caches) is not None and ndp > 1 and n % ndp == 0
    rows = dp_rows(n, mesh) if split else slice(0, n)
    hook = rows_hook(make_shard_fn(mesh) if shard_fn is None else shard_fn,
                     split)
    axis_bytes: Dict[str, int] = {}
    blocks: Dict[int, DTensor] = {}
    work = _decode_leaves(caches, axis_bytes, blocks)
    _count(axis_bytes, "decode caches")
    with _swapped(_owners(model), "model parameters"):
        logits, work = model.decode_step(token[rows], work, cache_index,
                                         shard_fn=hook)
        logits = gather_logits(logits, "decode logits")

    def put_back(old, new):
        if isinstance(old, Mapping):
            for k in old:
                old[k] = put_back(old[k], new[k])
            return old
        if isinstance(old, list):
            for i in range(len(old)):
                old[i] = put_back(old[i], new[i])
            return old
        if id(old) in blocks:
            if new is not blocks[id(old)]:      # replaced, not written in
                old.to_local().copy_(new)       # place: this rank's block
            return old
        if isinstance(old, DTensor):
            old.to_local().copy_(_nondp_cut(new, old))
            return old
        return new

    put_back(caches, work)
    return (gather_rows(logits, mesh, n) if split else logits), caches


def like(full: torch.Tensor, t: DTensor) -> DTensor:
    """``full`` (the same on every rank) at ``t``'s mesh and placements."""
    return _distribute(full, t.device_mesh, t.placements)
