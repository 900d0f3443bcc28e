"""B4: <x, y> in float32 on a hand-written Hopper kernel (``csrc/dotp.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dotp.py::dotp``
(``_dotp_kernel``). The TPU kernel streams (U, 128) tiles into U * 128
independent f32 chains, U from ``optimal_accumulators(n)`` (the paper's
eq. 3 applied to the VPU's add latency). The card hides latency with
threads instead: each thread keeps :data:`ILP` partial sums over a
grid-stride walk of 16-byte vectors (scalar loads for strided or unaligned
operands, :func:`vector_loads`), each CTA reduces its threads to one
partial, and the last CTA to finish (found by an integer ticket, one per
device and stream) sums the partials in a fixed order: one launch, no
float atomics, a bitwise repeatable result. The grid is exactly one wave
(:func:`dotp_grid`: at most :data:`CTAS_PER_SM` CTAs per SM, by the
occupancy query, times the SM count). The kernel is bound by bytes; see
the note at the top of ``csrc/dotp.cu``.

:func:`dotp` launches the kernel for CUDA tensors and runs
:func:`dotp_plain` for CPU tensors; there is no other path.
``dotp.launches`` counts kernel launches on the card and
``dotp.last_launch`` records the U of ``optimal_accumulators(n)`` (the
TPU's VPU count, recorded, not used: it does not fit this card) beside
the launch shape.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.codesign import optimal_accumulators
from repro_torch.kernels import _build
from repro_torch.kernels import launch_record as _rec

# csrc/dotp.cu's launch shape; a wave holds at most CTAS_PER_SM CTAs on
# each SM (fewer when the occupancy query says fewer fit)
THREADS, ILP, CTAS_PER_SM = 256, 4, 4
# the first pass's resident CTAs per SM on an H100 by (dtype, 16-byte
# loads), the occupancy query's answers (repro_dotp_blocks_per_sm): what a
# fake launch, which asks no card, takes; chip_smoke.py holds them to the
# card's
BLOCKS_PER_SM = {(torch.float32, False): 8, (torch.float32, True): 6,
                 (torch.float64, False): 8, (torch.float64, True): 6,
                 (torch.bfloat16, False): 8, (torch.bfloat16, True): 8}
VECTOR_BYTES = 16
# dtype codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def dotp_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: sum of the f32 products (0-d, f32)."""
    return torch.sum(x.float() * y.float())


def vector_loads(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel reads x and y as 16-byte vectors: both of stride
    1 with 16-byte aligned starts."""
    return x.stride(0) == 1 and y.stride(0) == 1 \
        and (_rec.address(x) | _rec.address(y)) % VECTOR_BYTES == 0


def dotp_grid(n: int, sms: int, per_sm: int, itemsize: int,
              vec: bool) -> int:
    """CTAs of the first pass: one whole wave (``per_sm`` resident CTAs,
    at most :data:`CTAS_PER_SM`, on each of ``sms`` SMs), or fewer when n
    leaves some CTA without a full ILP step of its own."""
    per_load = VECTOR_BYTES // itemsize if vec else 1
    units = max(1, n // per_load)
    wave = sms * min(per_sm, CTAS_PER_SM)
    return max(1, min(wave, -(-units // (THREADS * ILP))))


_waves = {}


def _wave(lib, device: torch.device, dtype: torch.dtype, vec: bool):
    """(SM count, first-pass CTAs one SM holds by the occupancy query) of
    ``device``, cached per (device, dtype, load width); raises if the
    query failed."""
    key = (device.index, dtype, vec)
    if key not in _waves:
        got = lib.repro_dotp_blocks_per_sm(DTYPE_CODES[dtype], int(vec))
        if got < 1:
            raise RuntimeError(f"dotp: occupancy query gave {got} ({dtype})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _waves[key] = (sms, got)
    return _waves[key]


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a cudaStream_t: the same
    handle as ``torch.cuda.current_stream().cuda_stream``, without
    building a Stream object on every call."""
    return torch._C._cuda_getCurrentRawStream(index)


_tickets = {}


def _ticket(index: int, stream: int) -> torch.Tensor:
    """The ticket (an int32, 0 between calls) by which the kernel's last
    CTA finds itself, one per (device, stream): calls on one stream run in
    order, so they share it. A call being captured into a CUDA graph gets
    its own, zeroed inside the capture, so no eager call ever uses one
    that only a graph's replay zeroes."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
    ticket = _tickets.get((index, stream))
    if ticket is None:
        ticket = _tickets[(index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=f"cuda:{index}")
    return ticket


# optimal_accumulators(n) is recorded on every call: cache it (its search
# costs more host time than the kernel's launch)
_accumulators = functools.lru_cache(maxsize=256)(optimal_accumulators)


def dotp(x: torch.Tensor, y: torch.Tensor,
         accumulators: Optional[int] = None) -> torch.Tensor:
    """<x, y> as a 0-d float32 tensor: the CUDA kernel for CUDA tensors,
    :func:`dotp_plain` for CPU tensors. ``accumulators`` (default
    ``optimal_accumulators(n)``) is recorded, not used."""
    if x.ndim != 1 or x.shape != y.shape:
        raise ValueError(f"dotp needs two vectors of one length; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    dev = x.device
    if dev != y.device or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dotp runs on cuda (kernel) or cpu (plain "
                         f"version); got {dev} and {y.device}")
    if dev.type == "cpu":
        return dotp_plain(x, y)
    if x.dtype != y.dtype or x.dtype not in DTYPE_CODES:
        raise ValueError(f"dotp on the card takes x and y of one of "
                         f"{tuple(DTYPE_CODES)}; got {x.dtype}, {y.dtype}")
    n = x.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    vec = vector_loads(x, y)
    recording = _rec.active()
    fake = recording and _rec.is_fake(x)
    if fake:
        # the analyzer's trace: the h100's answers in place of the card's
        # queries; nothing is built or launched
        sms, per_sm = _rec.h100().pe.sm_count, BLOCKS_PER_SM[x.dtype, vec]
        blocks = dotp_grid(n, sms, per_sm, x.element_size(), vec)
        buf = torch.empty(blocks + 1, dtype=torch.float32, device=dev)
        ptr = _rec.address(buf)
        _record((DTYPE_CODES[x.dtype], int(vec), _rec.address(x),
                 x.stride(0), _rec.address(y), y.stride(0), n, blocks, ptr,
                 0, ptr + 4 * blocks, None), vec, blocks, (x, y), True)
        return buf[blocks]
    # this path's host time shows in back-to-back timings against
    # torch.dot: few tensor calls, cached launch shape, and the device
    # guard only when another device is current
    lib = _build.library("dotp")
    sms, per_sm = _wave(lib, dev, x.dtype, vec)
    blocks = dotp_grid(n, sms, per_sm, x.element_size(), vec)
    # the CTAs' partials, then the result, in one allocation
    buf = torch.empty(blocks + 1, dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    stream = _raw_stream(dev.index)
    args = (DTYPE_CODES[x.dtype], int(vec), x.data_ptr(), x.stride(0),
            y.data_ptr(), y.stride(0), n, blocks, ptr,
            _ticket(dev.index, stream).data_ptr(), ptr + 4 * blocks, stream)
    if dev.index == torch.cuda.current_device():
        err = lib.repro_dotp(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.repro_dotp(*args)
    _build.check(err, "repro_dotp")
    dotp.launches += 1
    dotp.last_launch = {
        "accumulators": accumulators or _accumulators(n),
        "blocks": blocks, "sms": sms, "blocks_per_sm": per_sm,
        "vector_loads": vec, "threads": THREADS, "ilp": ILP, "n": n}
    if recording:
        _record(args, vec, blocks, (x, y), False)
    return buf[blocks]


def _record(args, vec, blocks, operands, fake):
    _rec.emit(__name__, "dotp", "dotp", "repro_dotp", args,
              variant="vector" if vec else "scalar", tile=(THREADS, ILP),
              grid=(blocks,), smem_bytes=0, operands=operands, fake=fake)


dotp.launches = 0
dotp.last_launch = None
