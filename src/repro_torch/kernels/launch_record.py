"""Launch records: what each kernel wrapper launches on the card, or would
launch on a fake one.

A wrapper of :mod:`repro_torch.kernels` (B1 ``gemm`` and its ``gemv``
entry, B3 ``gemm_bias_act``, B2 ``trsm_gemm``, B4 ``dotp``, B5
``attention``, B6 ``ssd_scan``) handed CUDA tensors builds the argument
list of its ``csrc`` entry point and calls it through ctypes. Inside a
:func:`record_launches` scope it also appends one record of that launch:

- ``kernel`` (the wrapper's name), ``entry`` (the C function) and
  ``variant``;
- ``tile`` (the CTA tile), ``grid`` and ``smem_bytes`` (dynamic shared
  memory; B6 gives one grid and one size per pass);
- ``operands``: (shape, dtype, strides, address mod 16) of each tensor
  handed over;
- ``ints``: the values passed through each ``c_int`` slot of the entry's
  :data:`repro_torch.kernels._build.SIGNATURES` line, in order;
- ``site`` (``repro_torch/kernels/<file>.py:<wrapper>``) and ``fake``.

Handed *fake* CUDA tensors (``torch._subclasses.FakeTensor`` on ``cuda``:
the static analyzer's trace of the card route), a wrapper builds the same
argument list, records it and returns a fake output of the right shape and
dtype; it never reaches :func:`~repro_torch.kernels._build.library` or
ctypes, and counts nothing. What the real launch asks the card (the SM
count, B2's co-resident CTAs) the fake one takes from the ``h100`` spec and
the wrappers' Python occupancy counterparts, and a tensor's address from its
storage offset (every allocation's base stands in as 0: the caching
allocator aligns them to 512 bytes). ``chip_smoke.py`` holds the records of
real calls on the card to those of fake traces.

The fake branch and the address stand-in are taken only inside a scope
(the analyzer's traces always open one). With no scope active a real
launch reads the scope's ``ContextVar`` once (:func:`active`), once more
for each alignment test its variant choice makes (:func:`address`: two
for a tiled B1, B4's two, B5's three, B6's three; none for ``gemv`` and
B2), and otherwise runs as it did before records existed. B7
(``fpu_chain``) and B8 (``pe_scoreboard``) lie on no linalg or model path
and record nothing.
"""
from __future__ import annotations

import contextlib
import ctypes
from contextvars import ContextVar
from typing import Dict, List, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

_RECORD: "ContextVar[Optional[List[Dict]]]" = ContextVar(
    "repro_torch_launch_record", default=None)


@contextlib.contextmanager
def record_launches():
    """Collect every launch record the wrappers emit inside the scope (real
    launches on the card and fake ones alike), in launch order."""
    rec: List[Dict] = []
    token = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(token)


def active() -> bool:
    """Is a :func:`record_launches` scope collecting?"""
    return _RECORD.get() is not None


def is_fake(t: torch.Tensor) -> bool:
    """Is ``t`` a fake tensor (the analyzer's trace), not a real one? The
    wrappers ask only inside a scope."""
    return isinstance(t, FakeTensor)


def address(t: torch.Tensor) -> int:
    """``t.data_ptr()``; inside a scope, for a fake tensor (which has no
    storage) its byte offset into its storage: a stand-in that keeps every
    alignment test of the wrappers, since real allocations start 512-byte
    aligned. A ``meta`` tensor's ``data_ptr()`` is that offset too."""
    if _RECORD.get() is not None and isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def operand(t: torch.Tensor) -> tuple:
    """(shape, dtype name, strides, address mod 16) of one operand."""
    return (tuple(int(d) for d in t.shape), str(t.dtype).replace("torch.", ""),
            tuple(int(s) for s in t.stride()), address(t) % 16)


def c_ints(lib: str, entry: str, args: Sequence) -> tuple:
    """The values of ``args`` in the ``c_int`` slots of ``entry``'s
    signature in :data:`~repro_torch.kernels._build.SIGNATURES`."""
    argtypes = _build.SIGNATURES[lib][entry][0]
    if len(argtypes) != len(args):
        raise ValueError(f"{entry}: {len(args)} arguments for "
                         f"{len(argtypes)} slots")
    return tuple(int(a) for a, t in zip(args, argtypes) if t is ctypes.c_int)


def emit(where: str, kernel: str, lib: str, entry: str, args: Sequence, *,
         variant, tile, grid, smem_bytes, operands: Sequence[torch.Tensor],
         fake: bool) -> None:
    """Append one launch record to the active scope, if any: ``where`` is
    the wrapper's module (``__name__``), ``lib`` / ``entry`` its ``csrc``
    stem and C function, ``args`` the C call's arguments."""
    rec = _RECORD.get()
    if rec is None:
        return
    rec.append({"kernel": kernel, "entry": entry, "variant": variant,
                "tile": tuple(tile) if tile is not None else None,
                "grid": grid, "smem_bytes": smem_bytes,
                "operands": tuple(operand(t) for t in operands),
                "ints": c_ints(lib, entry, args),
                "site": where.replace(".", "/") + f".py:{kernel}",
                "fake": bool(fake)})


def h100():
    """The fake card's machine spec (its SM count and shared memory)."""
    from repro_torch import arch
    return arch.get("h100")


def key(rec: Dict) -> tuple:
    """What a real launch and its fake trace must share: kernel, variant,
    tile, grid and shared memory."""
    return (rec["kernel"], rec["variant"], rec["tile"], rec["grid"],
            rec["smem_bytes"])
