"""The per-op-class dependent-chain probe on a hand-written kernel
(``csrc/fpu_chain.cu``).

Not a port of a TPU kernel: the card's counterpart of the jitted
``lax.fori_loop`` chains of ``repro/arch/calibrate.py``, which
:mod:`repro_torch.arch.calibrate` fits the FPU depths from. Each of 8
lanes of one warp applies one op of a class (:data:`OP_CLASSES`) to its
own loop-carried float32 value ``iters`` times; the kernel writes the
final values and the ``clock64`` cycles the chain took (a one-element
int64 tensor on the card, read without waiting for the launch), so
``cycles / iters`` is the class's dependent-issue latency in SM cycles.
What bounds it, and why one warp, is in the note at the top of the source.

:func:`fpu_chain` launches the kernel for CUDA tensors and runs
:func:`fpu_chain_plain` (the same loop in plain PyTorch, one op per step)
for CPU tensors, where there are no cycles to read (``None``). Every class
rounds as IEEE float32 does, so the two give the same bits.
``fpu_chain.launches`` counts kernel launches on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# op classes in csrc/fpu_chain.cu's code order
OP_CLASSES = ("mul", "add", "div", "sqrt")
LANES = 8
CHAIN_CONSTANT = 1.0000001       # the reference's c, rounded to float32


def chain_step(op: str, v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One step of the chain of class ``op`` on float32 ``v``; ``c`` is a
    tensor like ``v`` (PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, which is not IEEE division)."""
    if op == "mul":
        return v * c
    if op == "add":
        return v + c
    if op == "div":
        return v / c
    if op == "sqrt":
        return torch.sqrt(v) + 0.5
    raise ValueError(f"unknown op class {op!r}; expected one of {OP_CLASSES}")


def fpu_chain_plain(op: str, v0: torch.Tensor, iters: int,
                    c: float = CHAIN_CONSTANT) -> torch.Tensor:
    """The plain version: ``iters`` steps of :func:`chain_step`."""
    v = v0.clone()
    ct = torch.full_like(v, c)
    for _ in range(int(iters)):
        v = chain_step(op, v, ct)
    return v


def fpu_chain(op: str, v0: torch.Tensor, iters: int,
              c: float = CHAIN_CONSTANT
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(values, cycles) of the dependent chain of class ``op`` from
    ``v0`` (8 float32 lanes): the kernel for a CUDA ``v0`` (cycles: a
    one-element int64 tensor the kernel writes from ``clock64``), the plain
    version for a CPU one (cycles ``None``)."""
    if op not in OP_CLASSES:
        raise ValueError(f"unknown op class {op!r}; expected one of "
                         f"{OP_CLASSES}")
    if v0.shape != (LANES,) or v0.dtype != torch.float32:
        raise ValueError(f"fpu_chain takes ({LANES},) float32 values, got "
                         f"{tuple(v0.shape)} {v0.dtype}")
    if int(iters) < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if v0.device.type == "cpu":
        return fpu_chain_plain(op, v0, iters, c), None
    if v0.device.type != "cuda":
        raise ValueError(f"fpu_chain runs on cuda or cpu, not {v0.device}")
    v0 = v0.contiguous()
    out = torch.empty_like(v0)
    cycles = torch.empty((1,), dtype=torch.int64, device=v0.device)
    lib = _build.library("fpu_chain")
    with torch.cuda.device(v0.device):
        err = lib.repro_fpu_chain(OP_CLASSES.index(op), v0.data_ptr(),
                                  float(c), int(iters), out.data_ptr(),
                                  cycles.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "repro_fpu_chain")
    fpu_chain.launches += 1
    return out, cycles


fpu_chain.launches = 0
