"""B8: the paper's cycle-level PE scoreboard on a hand-written kernel
(``csrc/pe_scoreboard.cu``).

Not a port of a TPU kernel: the card's counterpart of the jitted, vmapped
``lax.scan`` of ``repro/core/pe.py::_scoreboard`` / ``_scoreboard_sweep``,
which :mod:`repro_torch.core.pe` runs the section-5 instruction streams
on. For each of C latency vectors ``lat[c]`` (int32, one entry per opcode)
over one SSA stream ``opcode`` / ``src1`` / ``src2`` (int32 [n]; a source
of -1 is an RF-resident operand, ready at cycle 0), the in-order
stall-on-use recurrence::

    issue[i] = max(issue[i-1] + 1, ready[src1[i]], ready[src2[i]])
    ready[i] = issue[i] + lat[c][opcode[i]]

gives ``cycles[c] = max(ready)`` and ``stalls[c] = sum(issue[i] -
issue[i-1] - 1)`` (``issue[-1] = -1``), int32 as the reference. Inputs
outside a compiled stream's range follow the reference's gathers: a
negative opcode wraps once and is clamped to [0, 6]; a negative source
reads 0; a source at or after its own instruction (``src >= i``, ``src >=
n`` included, which the reference clamps to a slot still 0) reads 0. An
empty stream is refused, as the reference's ``max`` over no instructions
is.

:func:`pe_scoreboard` launches the kernel for CUDA tensors and runs
:func:`pe_scoreboard_plain` (the same recurrence in Python over the
stream's ``.tolist()``) for CPU tensors; there is no other path, and a
refused shared-memory opt-in or launch raises. The kernel (one CTA per
configuration, one thread walking the recurrence) keeps ``ready[]`` on
chip: the last :data:`WINDOW` values in a shared-memory ring, the last
:data:`NEAR` issues in registers, and sources further back than the ring
staged as values by the CTA's other warps, :data:`CHUNK` instructions at a
time, from a C x n device-memory copy allocated here (written before any
slot of it is read: not zeroed). ``pe_scoreboard.launches`` counts kernel
launches on the card. What bounds the kernel, and the design in full, are
in the note at the top of the source.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

N_OPCODES = 7          # NOP, MUL, ADD, DIV, SQRT, FMA, DOT4 (core/isa.py)
# the kernel's geometry (csrc/pe_scoreboard.cu; the card tests hold these
# to repro_pe_scoreboard_geometry and build streams at their edges):
# instructions staged per buffer, ready[] values in the shared-memory ring,
# issues kept in registers (sources 1..NEAR back), steps per unrolled group
CHUNK, WINDOW, NEAR, UNROLL = 1024, 32768, 4, 8


def _check(opcode, src1, src2, lat) -> Tuple[int, int]:
    for name, t in (("opcode", opcode), ("src1", src1), ("src2", src2),
                    ("lat", lat)):
        if t.dtype != torch.int32:
            raise ValueError(f"pe_scoreboard takes int32 tensors; {name} is "
                             f"{t.dtype}")
        if t.device != opcode.device:
            raise ValueError(f"pe_scoreboard's operands must share a device;"
                             f" {name} is on {t.device}, opcode on "
                             f"{opcode.device}")
    n = opcode.shape[0] if opcode.ndim == 1 else -1
    if n < 0 or src1.shape != (n,) or src2.shape != (n,):
        raise ValueError(f"pe_scoreboard takes opcode / src1 / src2 of one "
                         f"shape [n]; got {tuple(opcode.shape)}, "
                         f"{tuple(src1.shape)}, {tuple(src2.shape)}")
    if lat.ndim != 2 or lat.shape[1] != N_OPCODES or lat.shape[0] == 0:
        raise ValueError(f"pe_scoreboard takes lat of shape [C, "
                         f"{N_OPCODES}], C >= 1; got {tuple(lat.shape)}")
    if n == 0:
        raise ValueError("pe_scoreboard of an empty stream: cycles = "
                         "max(ready) has no instruction to take the maximum "
                         "of (the reference refuses it too)")
    if n >= 2 ** 31:
        raise ValueError(f"pe_scoreboard takes n < 2^31 instructions; got "
                         f"{n}")
    return n, lat.shape[0]


def pe_scoreboard_plain(opcode: torch.Tensor, src1: torch.Tensor,
                        src2: torch.Tensor, lat: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the recurrence in Python over the stream, one
    configuration after the other; ``(cycles[C], stalls[C])`` int32 on the
    operands' device."""
    n, configs = _check(opcode, src1, src2, lat)
    op = opcode.cpu().numpy().astype(np.int64)
    op = np.clip(np.where(op < 0, op + N_OPCODES, op), 0, N_OPCODES - 1)
    # ready[n] stays 0: the slot an RF-resident (negative) source reads
    srcs = []
    for s in (src1, src2):
        s = s.cpu().numpy().astype(np.int64)
        srcs.append(np.where(s >= 0, np.minimum(s, n - 1), n).tolist())
    cycles, stalls = [], []
    for row in lat.cpu().numpy().astype(np.int64):
        ready = [0] * (n + 1)
        prev, last = -1, None
        for i, (a, b, d) in enumerate(zip(srcs[0], srcs[1],
                                          row[op].tolist())):
            r, r2 = ready[a], ready[b]
            if r2 > r:
                r = r2
            issue = prev + 1
            if r > issue:
                issue = r
            fin = issue + d
            ready[i] = fin
            if last is None or fin > last:
                last = fin
            prev = issue
        cycles.append(last)
        # sum(issue[i] - issue[i-1] - 1) telescopes to issue[n-1] + 1 - n
        stalls.append(prev + 1 - n)
    return (torch.tensor(cycles, dtype=torch.int32, device=opcode.device),
            torch.tensor(stalls, dtype=torch.int32, device=opcode.device))


def pe_scoreboard(opcode: torch.Tensor, src1: torch.Tensor,
                  src2: torch.Tensor, lat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cycles[C], stalls[C])`` int32 of the stream at each row of
    ``lat`` [C, 7]: the CUDA kernel for CUDA tensors,
    :func:`pe_scoreboard_plain` for CPU tensors."""
    n, configs = _check(opcode, src1, src2, lat)
    dev = opcode.device
    if dev.type == "cpu":
        return pe_scoreboard_plain(opcode, src1, src2, lat)
    if dev.type != "cuda":
        raise ValueError(f"pe_scoreboard runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev}")
    opcode, src1, src2, lat = (t.contiguous()
                               for t in (opcode, src1, src2, lat))
    ready = torch.empty((configs, n), dtype=torch.int32, device=dev)
    cycles = torch.empty(configs, dtype=torch.int32, device=dev)
    stalls = torch.empty(configs, dtype=torch.int32, device=dev)
    lib = _build.library("pe_scoreboard")
    with torch.cuda.device(dev):
        err = lib.repro_pe_scoreboard(
            opcode.data_ptr(), src1.data_ptr(), src2.data_ptr(), n,
            lat.data_ptr(), configs, ready.data_ptr(), cycles.data_ptr(),
            stalls.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "repro_pe_scoreboard")
    pe_scoreboard.launches += 1
    return cycles, stalls


pe_scoreboard.launches = 0
