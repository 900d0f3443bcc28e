"""Manual collectives on torch.distributed (port of
``repro.distributed.collectives``): the SUMMA ring broadcast, compressed
gradient sync and flash-decoding.

The reference's functions run inside ``shard_map`` over global arrays;
here each rank runs one process and every function is an SPMD call that
all ranks of the mesh make with the same arguments (the same global
operands, made from the same seed). A rank takes its shard by its mesh
coordinates (``DeviceMesh.get_local_rank``) and talks over the mesh
axis's sub-group (``DeviceMesh.get_group``).

1. **Ring broadcast** (:func:`ring_bcast`): the SUMMA panel movement,
   ``size - 1`` point-to-point hops (``P2POp`` + ``batch_isend_irecv``)
   around the axis's ring, each rank sending to its successor and taking
   from its predecessor, as the reference's ``lax.ppermute`` hops do.
2. **int8-compressed gradient mean with error feedback**
   (:func:`compressed_mean`, :func:`compressed_grad_sync`): gradients are
   blockwise-quantized to int8 before they cross the link, and the
   quantization residual is fed back into the next step's gradient. The
   codes and the f32 block scales are all-gathered.
3. **Flash-decoding over a sequence-sharded KV cache**
   (:func:`sharded_decode_attention`): each rank computes a partial
   softmax (m, l, o) over its chunk of the cache; the combine is an
   ``all_reduce`` MAX, then SUM, over "model".

Records and counters (:class:`CollectiveRecord`, ``collective.hops`` /
``collective.bytes``, the ``collective.ring_bcast`` event) are emitted at
run time, once per call, where the reference emits them once per traced
schedule; one call's list equals one reference trace's, field for field.
A second stream, :func:`record_transport`, holds what each rank actually
did (:class:`TransportRecord`): the (send-to, receive-from) pair and the
hops of each ``ring_bcast`` loop, every ``all_gather_cat`` (the routines'
final result gathers tagged ``"result"``), every ``reduce_scatter_chunk``
and ``all_reduce``, and the operand partition each mesh routine takes;
the static analyzer's CC and SH rules read it, and the dry run holds its
aten-level collective bytes to it. A backward records into the scope
that was active at its forward, and emits its obs events into the
forward's trace (:func:`transport_scope`), on whatever thread autograd
runs it.

Transport follows the group's backend, never a caught error: NCCL moves
tensors on the card; gloo moves host memory, so a tensor on the card is
copied to pinned host memory before a gloo collective and back after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch import _dtype
from repro_torch import obs as _obs
from repro_torch.obs import counters as _counters

Q_BLOCK = 256


# ---------------------------------------------------------------------------
# collective metadata (the spmd_lint "record view")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One communication/padding fact of a call, kind-tagged (the
    reference's fields): ``"ring_bcast"`` (one SUMMA panel movement:
    axis/size/src/hops/bytes), ``"pdgemm"`` (one whole pdgemm schedule;
    ``info`` carries the geometry ``plan_pdgemm`` prices), ``"pad_batch"``
    (one ragged-batch identity pad; ``info`` carries batch/pad/identity).
    Dtype names are numpy's (``"float32"``)."""

    kind: str
    axis: Optional[str] = None
    size: int = 1
    src: int = 0
    hops: int = 0
    per_hop_bytes: int = 0
    wire_bytes: int = 0
    info: Optional[Dict] = None


_RECORD: "ContextVar[Optional[List[CollectiveRecord]]]" = ContextVar(
    "repro_torch_collective_record", default=None)


@contextlib.contextmanager
def record_collectives():
    """Collect every CollectiveRecord the calls inside the scope emit."""
    rec: List[CollectiveRecord] = []
    token = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(token)


def emit_record(rec: CollectiveRecord) -> None:
    """Append to the active :func:`record_collectives` scope, if any."""
    lst = _RECORD.get()
    if lst is not None:
        lst.append(rec)


@dataclasses.dataclass(frozen=True)
class TransportRecord:
    """What one rank did, kind-tagged: ``"hop"`` (one ``ring_bcast`` loop:
    the global ranks it sent to and took from, the hops it made and the
    bytes it sent), ``"all_gather"`` (one gather over ``axis``: ``bytes``
    of this rank's shard; ``tag`` ``"result"`` for a routine's final result
    gather, else ``"body"``), ``"reduce_scatter"`` / ``"all_reduce"`` (one
    over ``axis``: ``bytes`` of the tensor this rank puts in),
    ``"partition"`` (one operand's split over the mesh: ``info`` carries the routine, operand, global and padded shapes,
    the spec {dim: axes}, the mesh's {axis: size} and the block taken).
    ``group`` is the axis group's global ranks in axis order, ``index``
    this rank's place in it."""

    kind: str
    rank: int = 0
    axis: Optional[str] = None
    group: Tuple[int, ...] = ()
    index: int = 0
    send_to: Optional[int] = None
    recv_from: Optional[int] = None
    hops: int = 0
    bytes: int = 0
    tag: Optional[str] = None
    info: Optional[Dict] = None


_TRANSPORT: "ContextVar[Optional[List[TransportRecord]]]" = ContextVar(
    "repro_torch_transport_record", default=None)


@contextlib.contextmanager
def record_transport():
    """Collect every TransportRecord this rank emits inside the scope."""
    rec: List[TransportRecord] = []
    token = _TRANSPORT.set(rec)
    try:
        yield rec
    finally:
        _TRANSPORT.reset(token)


@dataclasses.dataclass(frozen=True)
class ForwardScopes:
    """The scopes active at an op's forward that its backward re-enters:
    the :func:`record_transport` list and obs's trace (each None where
    none was active)."""

    transport: Optional[List[TransportRecord]]
    trace: Optional[object]


def forward_scopes() -> ForwardScopes:
    """The :func:`record_transport` list and the obs trace active here:
    what an ``autograd.Function`` keeps at its forward for
    :func:`transport_scope` to re-enter in its backward."""
    return ForwardScopes(_TRANSPORT.get(), _obs.current_trace())


@contextlib.contextmanager
def transport_scope(scopes: ForwardScopes):
    """Record into the forward's transport list and emit obs events into
    its trace (``scopes``, a :func:`forward_scopes`) inside the scope. A
    backward and remat's recompute run where the forward's scopes may be
    unseen: on CUDA tensors autograd runs them on its device thread,
    which starts with none of the caller's ContextVars."""
    token = _TRANSPORT.set(scopes.transport)
    try:
        with _obs.capture(scopes.trace):
            yield scopes
    finally:
        _TRANSPORT.reset(token)


def _transport(group, axis: str, idx: int, **fields) -> None:
    lst = _TRANSPORT.get()
    if lst is not None:
        lst.append(TransportRecord(
            rank=dist.get_rank(), axis=str(axis),
            group=tuple(dist.get_process_group_ranks(group)), index=int(idx),
            **fields))


def emit_partition(routine: str, operand: str, shape, padded, spec: Dict,
                   block, mesh) -> None:
    """Record one operand's split over ``mesh`` (a ``"partition"``
    TransportRecord): its global and padded shapes, the spec {dim: mesh
    axes} and the block this rank took."""
    lst = _TRANSPORT.get()
    if lst is not None:
        lst.append(TransportRecord(
            kind="partition", rank=dist.get_rank(), info={
                "routine": routine, "operand": operand,
                "shape": [int(d) for d in shape],
                "padded": [int(d) for d in padded],
                "spec": {int(d): list(a) for d, a in spec.items()},
                "mesh": {str(a): int(n) for a, n in
                         zip(mesh.mesh_dim_names, mesh.shape)},
                "block": [int(d) for d in block]}))


# ---------------------------------------------------------------------------
# mesh axes and transport
# ---------------------------------------------------------------------------

def axis_group(mesh, axis: str):
    """(group, size, this rank's index) of one mesh axis; raises on a rank
    that holds no coordinate in ``mesh``."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), int(mesh.shape[dim]), \
        int(mesh.get_local_rank(axis))


def _staged(group, t: torch.Tensor) -> bool:
    """Must ``t`` cross ``group`` through host memory (gloo, on the card)?"""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire_empty(group, like: torch.Tensor, shape) -> torch.Tensor:
    """An empty transport buffer of ``shape`` for tensors like ``like``:
    on ``like``'s device, or in pinned host memory for gloo on the card."""
    if _staged(group, like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return like.new_empty(shape)


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """The buffer the group's transport reads for ``t``: ``t`` itself
    (contiguous), or a pinned host copy for gloo on the card."""
    if not _staged(group, t):
        return t.contiguous()
    return _wire_empty(group, t, t.shape).copy_(t)


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A transport buffer on ``like``'s device."""
    return buf if buf.device == like.device else buf.to(like.device)


def all_gather_cat(t: torch.Tensor, mesh, axis: str, dim: int,
                   tag: str = "body") -> torch.Tensor:
    """The shards of ``t`` along mesh ``axis``, concatenated along tensor
    dim ``dim`` in axis order (one ``all_gather_into_tensor``); ``tag``
    (``"result"`` for a routine's final result gather) goes to the
    ``"all_gather"`` TransportRecord."""
    group, size, idx = axis_group(mesh, axis)
    _transport(group, axis, idx, kind="all_gather", tag=tag,
               bytes=t.numel() * t.element_size() if size > 1 else 0)
    if size == 1:
        return t
    out = _wire_empty(group, t, (size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, _wire(group, t), group=group)
    out = _back(out, t)
    return out if dim == 0 else torch.cat(out.chunk(size, 0), dim)


def reduce_scatter_chunk(t: torch.Tensor, mesh, axis: str,
                         dim: int) -> torch.Tensor:
    """``t`` summed over mesh ``axis``, this rank's chunk of it along
    tensor dim ``dim`` (the axis's ranks take the chunks in axis order;
    one ``reduce_scatter_tensor``)."""
    group, size, idx = axis_group(mesh, axis)
    _transport(group, axis, idx, kind="reduce_scatter",
               bytes=t.numel() * t.element_size() if size > 1 else 0)
    if size == 1:
        return t
    chunks = torch.stack(t.chunk(size, dim))          # (size, *chunk)
    out = _wire_empty(group, t, (chunks[0].numel(),))
    dist.reduce_scatter_tensor(out, _wire(group, chunks.reshape(-1)),
                               group=group)
    return _back(out, t).reshape(chunks.shape[1:])


def all_reduce(t: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    """``t`` reduced with ``op`` over mesh ``axis`` (a new tensor)."""
    group, size, idx = axis_group(mesh, axis)
    _transport(group, axis, idx, kind="all_reduce",
               bytes=t.numel() * t.element_size() if size > 1 else 0)
    if size == 1:
        return t
    buf = _wire(group, t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=op, group=group)
    return _back(buf, t)


# ---------------------------------------------------------------------------
# ring broadcast: the SUMMA panel-movement primitive
# ---------------------------------------------------------------------------

def ring_bcast(val: torch.Tensor, mesh, axis_name: str,
               src: int) -> torch.Tensor:
    """Broadcast ``val`` from index ``src`` along mesh axis ``axis_name``
    by a ring of ``size - 1`` hops; every rank of the axis calls it.

    Each hop every rank sends its buffer to its ring successor and takes
    its predecessor's (one ``batch_isend_irecv`` pair per hop); a rank
    adopts the incoming buffer exactly when it is ``src``'s (step+1)-th
    successor, so after ``size - 1`` hops every rank holds ``src``'s
    panel. Each hop moves ``val``'s bytes on every link
    (:func:`ring_bcast_bytes`, what ``plan_pdgemm`` prices).

    Observability, per call: the ``collective.hops`` /
    ``collective.bytes`` counters, a ``"ring_bcast"``
    :class:`CollectiveRecord`, and under an active trace a
    ``collective.ring_bcast`` event priced against the ``ici_bw`` of the
    machine of ``val``'s device.
    """
    group, size, idx = axis_group(mesh, axis_name)
    if size <= 1:
        emit_record(CollectiveRecord(kind="ring_bcast", axis=str(axis_name),
                                     size=int(size), src=int(src)))
        _transport(group, axis_name, idx, kind="hop")
        return val
    hops = size - 1
    dtype_name = _dtype.name(val.dtype)
    panel_bytes = val.numel() * val.element_size()
    wire_bytes = ring_bcast_bytes(panel_bytes, size)
    _counters.inc("collective.hops", hops)
    _counters.inc("collective.bytes", wire_bytes)
    emit_record(CollectiveRecord(
        kind="ring_bcast", axis=str(axis_name), size=int(size),
        src=int(src), hops=hops, per_hop_bytes=panel_bytes,
        wire_bytes=wire_bytes,
        info={"shape": list(val.shape), "dtype": dtype_name}))
    if _obs.enabled():
        from repro_torch import arch          # lazy: avoid an import cycle
        attrs = {"axis": axis_name, "size": size, "src": int(src),
                 "hops": hops, "per_hop_bytes": panel_bytes,
                 "wire_bytes": wire_bytes, "shape": list(val.shape),
                 "dtype": dtype_name}
        ici = arch.current_machine(val.device).memory.ici_bw
        if ici > 0:
            attrs.update(ici_bw=ici, modeled_hop_s=panel_bytes / ici,
                         modeled_s=wire_bytes / ici)
        _obs.event("collective.ring_bcast", cat="collective", **attrs)
    succ = dist.get_global_rank(group, (idx + 1) % size)
    pred = dist.get_global_rank(group, (idx - 1) % size)
    buf = _wire(group, val)
    done = 0
    for step in range(hops):
        nxt = _wire_empty(group, val, val.shape)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, succ, group),
            dist.P2POp(dist.irecv, nxt, pred, group)])
        for r in reqs:
            r.wait()
        done += 1
        if idx == (src + step + 1) % size:
            buf = nxt
    _transport(group, axis_name, idx, kind="hop", send_to=succ,
               recv_from=pred, hops=done, bytes=done * panel_bytes)
    return val if idx == src else _back(buf, val)


def ring_bcast_bytes(panel_bytes: int, size: int) -> int:
    """On-wire bytes per participating link for one ring broadcast: the
    panel crosses ``size - 1`` hops, each carrying the full panel."""
    return int(panel_bytes) * max(int(size) - 1, 0)


# ---------------------------------------------------------------------------
# int8-compressed gradient mean with error feedback
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes (blocks, Q_BLOCK), f32 block scales (blocks, 1))."""
    flat = x.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % Q_BLOCK)).reshape(-1, Q_BLOCK)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(fp / safe), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    fp = q.float() * scale
    n = 1
    for d in shape:
        n *= int(d)
    return fp.reshape(-1)[:n].reshape(shape)


def compressed_mean(x: torch.Tensor, err: torch.Tensor, mesh,
                    axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of each rank's ``x`` over ``axis_name`` with int8 on-wire
    compression and error feedback: (mean, new_err). The codes and scales
    of every rank are all-gathered and summed in rank order, so every rank
    gets the same mean bitwise."""
    _, n, _ = axis_group(mesh, axis_name)
    y = x + err
    q, scale = _quantize(y)
    new_err = y - _dequantize(q, scale, x.shape)       # feedback residual
    qs = all_gather_cat(q, mesh, axis_name, 0)         # (n * blocks, Q)
    ss = all_gather_cat(scale, mesh, axis_name, 0)
    total = (qs.float() * ss).reshape(n, -1, Q_BLOCK).sum(dim=0)
    nel = x.numel()
    mean = total.reshape(-1)[:nel].reshape(x.shape) / n
    return mean, new_err


def compressed_grad_sync(mesh, axis_name: str = "pod"):
    """``sync(grads, errs) -> (means, new_errs)`` over one mesh axis, with
    int8 compression and error feedback: ``grads`` is this rank's local
    gradient tree (mappings / lists / tuples of tensors), ``errs`` its
    error-feedback buffers of the same structure. Every rank of the axis
    calls it; every rank returns the same means."""
    def sync(grads, errs):
        leaves, spec = pytree.tree_flatten(grads)
        out = [compressed_mean(g, e, mesh, axis_name)
               for g, e in zip(leaves, pytree.tree_leaves(errs))]
        return (pytree.tree_unflatten([o[0] for o in out], spec),
                pytree.tree_unflatten([o[1] for o in out], spec))
    return sync


# ---------------------------------------------------------------------------
# flash-decoding over a sequence-sharded cache
# ---------------------------------------------------------------------------

def _partial_softmax_attention(q, k, v, valid):
    """q (B,Hq,D); k,v (B,Hkv,Sc,D); valid (B,1,Sc) bool -> (o, m, l)."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) / (d ** 0.5)
    s = torch.where(valid[:, :, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                                   # (b,hkv,g)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def flat_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's row-major index over mesh ``axes``, their size): where
    its shard of an axis sharded over them starts, as ``P(axes)``."""
    idx, n = 0, 1
    for a in axes:
        _, size, i = axis_group(mesh, a)
        idx, n = idx * size + i, n * size
    return idx, n


def combine_partials(o, m, l, mesh, axis: str = "model") -> torch.Tensor:
    """Every rank's partial softmax over its block of the sequence, (o, m,
    l) as :func:`_partial_softmax_attention` gives them, combined over
    mesh ``axis``: an ``all_reduce`` MAX of m, then SUMs of l and o, each
    rescaled by exp(m - max). A rank whose block holds no valid key (m =
    -1e30) adds exp(-1e30 - max) = 0 of each. Returns (B, Hq, D) in f32."""
    m_g = all_reduce(m, mesh, axis, dist.ReduceOp.MAX)
    corr = torch.exp(m - m_g)
    l_g = all_reduce(l * corr, mesh, axis, dist.ReduceOp.SUM)
    o_g = all_reduce(o * corr[..., None], mesh, axis, dist.ReduceOp.SUM)
    safe = torch.where(l_g > 0, l_g, torch.ones_like(l_g))
    return o_g / safe[..., None]


def block_decode_attention(q, k, v, start: int, lens, mesh,
                           axis: str = "model") -> torch.Tensor:
    """Flash-decoding on this rank's block of a cache split over mesh
    ``axis`` along its sequence: q (B, Hq, D) every head; k, v (B, Sc,
    Hkv, D) the block, its first slot ``start``; ``lens`` (B,) each
    row's valid length (a key is valid where its position is below it).
    The partial softmax over the block, combined over ``axis``
    (:func:`combine_partials`); (B, Hq, D) in f32."""
    kpos = start + torch.arange(k.shape[1], device=q.device)
    valid = (kpos[None, :] < lens[:, None])[:, None, :]      # (B, 1, Sc)
    o, m, l = _partial_softmax_attention(q, k.transpose(1, 2),
                                         v.transpose(1, 2), valid)
    return combine_partials(o, m, l, mesh, axis)


def sharded_decode_attention(mesh, dp_axes):
    """Builds ``decode_attn(q, k_cache, v_cache, kv_len)`` with the cache's
    S dim sharded over "model" and the batch over the ``dp_axes``.

    q: (B, Hq, D); caches (B, S, Hkv, D); kv_len: the valid cache length,
    a scalar as in the reference or one per batch row (B,). Every rank of
    the mesh calls it with the global arrays and takes its shard: batch
    rows by its index over ``dp_axes``, cache positions by its "model"
    index. The partial softmax of each shard is combined by an
    ``all_reduce`` MAX, then SUM, over "model"
    (:func:`block_decode_attention`); the (B, Hq, D) output is gathered
    over the ``dp_axes``, so every rank returns all of it. The
    reference's ``kv_len_static`` argument, which changes nothing there,
    is left out."""
    dp = tuple(dp_axes)

    def decode_attn(q, k, v, kv_len):
        di, ndp = flat_index(mesh, dp)
        mi, nmodel = flat_index(mesh, ("model",))
        b, s = q.shape[0], k.shape[1]
        if b % ndp or s % nmodel:
            raise ValueError(f"batch {b} over {ndp} data ranks and cache "
                             f"length {s} over {nmodel} model ranks must "
                             f"divide")
        bl, sl = b // ndp, s // nmodel
        rows = slice(di * bl, (di + 1) * bl)
        cols = slice(mi * sl, (mi + 1) * sl)
        lens = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        lens = lens.expand(b)[rows]
        out = block_decode_attention(q[rows], k[rows, cols], v[rows, cols],
                                     mi * sl, lens, mesh).to(q.dtype)
        for a in reversed(dp):
            out = all_gather_cat(out, mesh, a, 0)
        return out

    return decode_attn
