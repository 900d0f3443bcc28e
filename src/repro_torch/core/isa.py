"""PE instruction set + BLAS/LAPACK instruction-stream compilers (port of
``repro.core.isa``).

The paper's experimental setup (section 5, fig. 11) is a scalar Processing
Element whose four floating-point units (multiplier / adder / divider /
square root) have *configurable pipeline depths*, fed by instruction streams
compiled from BLAS and LAPACK routines. This module is that apparatus:

  * a tiny SSA ISA (every instruction's destination is its own index),
  * compilers that lower ddot / dgemv / dgemm / DGEQRF / DGETRF / DPOTRF into
    literal dataflow instruction streams, carrying the *true* dependence
    structure (the matrix is tracked as an SSA id table across updates, so a
    column norm in QR step k really depends on step k-1's trailing update).

Stream construction is host-side data preparation: numpy int32 arrays,
bitwise the reference's streams (``tests/test_torch_isa.py``). The streams
are executed by the cycle-level scoreboard of :mod:`repro_torch.core.pe`
(on the card: ``csrc/pe_scoreboard.cu``).

The "enhanced PE" of section 5 reconfigures 4 multipliers + 3 adders into a
DOT4 instruction; ``dot4=True`` in the GEMM/ddot compilers emits that form.
The LAP-PE baseline [2][5] executes FMACs; ``fma=True`` emits chained FMAs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# Opcodes. RF-resident operands (preloaded by the APE per the paper's step
# 1-2) appear as src = -1: ready at cycle 0.
NOP, MUL, ADD, DIV, SQRT, FMA, DOT4 = 0, 1, 2, 3, 4, 5, 6
OPCODE_NAMES = {NOP: "nop", MUL: "mul", ADD: "add", DIV: "div", SQRT: "sqrt",
                FMA: "fma", DOT4: "dot4"}
# FLOPs retired per instruction (double precision).
OPCODE_FLOPS = {NOP: 0, MUL: 1, ADD: 1, DIV: 1, SQRT: 1, FMA: 2, DOT4: 7}
# Which depth-configured unit produces the latency of each opcode:
# fma = mul chained into add; dot4 = mul + 2 adder-tree levels.
N_OPCODES = 7


@dataclasses.dataclass
class InstrStream:
    """A compiled instruction stream in SSA form.

    ``opcode[i]`` executes with operands ``src1[i]``/``src2[i]`` (indices of
    earlier instructions, or -1 for RF-resident inputs) and defines value
    ``i``.  In-order single-issue, stall-on-use - exactly the paper's scalar
    PE front end.
    """

    name: str
    opcode: np.ndarray          # int32[N]
    src1: np.ndarray            # int32[N]
    src2: np.ndarray            # int32[N]

    @property
    def n_instructions(self) -> int:
        return int(self.opcode.shape[0])

    @property
    def flops(self) -> int:
        counts = np.bincount(self.opcode, minlength=N_OPCODES)
        return int(sum(OPCODE_FLOPS[op] * int(c) for op, c in enumerate(counts)))

    def census(self) -> Dict[str, int]:
        """Instruction count per paper op class (dot4/fma folded into mul+add)."""
        counts = np.bincount(self.opcode, minlength=N_OPCODES)
        return {
            "mul": int(counts[MUL] + counts[FMA] + 4 * counts[DOT4]),
            "add": int(counts[ADD] + counts[FMA] + 3 * counts[DOT4]),
            "div": int(counts[DIV]),
            "sqrt": int(counts[SQRT]),
        }

    def hazard_census(self, window: int = 1) -> Dict[str, int]:
        """Dependency hazards per class: instructions whose operand is
        produced fewer than ``window`` slots earlier (back-to-back dependences
        that necessarily expose pipe latency on the in-order PE)."""
        idx = np.arange(self.n_instructions)
        near1 = (self.src1 >= 0) & (idx - self.src1 <= window)
        near2 = (self.src2 >= 0) & (idx - self.src2 <= window)
        haz = near1 | near2
        out = {}
        for cls, ops in (("mul", (MUL,)), ("add", (ADD, FMA, DOT4)),
                         ("div", (DIV,)), ("sqrt", (SQRT,))):
            m = np.isin(self.opcode, ops)
            out[cls] = int(np.sum(haz & m))
        return out


class _Builder:
    """Append-only SSA stream builder (list-of-chunks, O(1) amortized)."""

    def __init__(self, name: str):
        self.name = name
        self._op: List[np.ndarray] = []
        self._s1: List[np.ndarray] = []
        self._s2: List[np.ndarray] = []
        self._n = 0

    def emit_block(self, opcode, src1, src2) -> np.ndarray:
        """Emit a vector of instructions; returns their SSA ids."""
        op = np.asarray(opcode, dtype=np.int32)
        s1 = np.asarray(src1, dtype=np.int32)
        s2 = np.asarray(src2, dtype=np.int32)
        op, s1, s2 = np.broadcast_arrays(op, s1, s2)
        ids = np.arange(self._n, self._n + op.size, dtype=np.int32)
        self._op.append(op.ravel().astype(np.int32))
        self._s1.append(s1.ravel().astype(np.int32))
        self._s2.append(s2.ravel().astype(np.int32))
        self._n += op.size
        return ids

    def emit(self, opcode: int, src1: int = -1, src2: int = -1) -> int:
        return int(self.emit_block([opcode], [src1], [src2])[0])

    def tree_reduce(self, ids: np.ndarray, opcode: int = ADD) -> int:
        """Balanced binary reduction; returns the root id."""
        ids = np.asarray(ids, dtype=np.int32)
        while ids.size > 1:
            half = ids.size // 2
            left, right = ids[:half], ids[half:2 * half]
            new = self.emit_block(np.full(half, opcode), left, right)
            ids = np.concatenate([new, ids[2 * half:]])
        return int(ids[0])

    def chain_reduce(self, ids: np.ndarray, opcode: int = ADD) -> int:
        """Sequential accumulation a+=x (the fully serial schedule)."""
        ids = np.asarray(ids, dtype=np.int32)
        acc = int(ids[0])
        for v in ids[1:]:
            acc = self.emit(opcode, acc, int(v))
        return acc

    def strided_reduce(self, ids: np.ndarray, accumulators: int) -> int:
        """U parallel partial sums, round-robin, then a tree combine.

        This is the TPU-codesign schedule: U plays the role of pipeline depth
        p - each partial-sum chain sees a new operand every U issue slots.
        """
        ids = np.asarray(ids, dtype=np.int32)
        u = max(1, min(int(accumulators), ids.size))
        accs = list(ids[:u].astype(int))
        rest = ids[u:]
        # round-robin: emit in interleaved order so chains alternate.
        for start in range(0, rest.size, u):
            block = rest[start:start + u]
            new = self.emit_block(np.full(block.size, ADD),
                                  np.asarray(accs[:block.size]), block)
            accs[:block.size] = list(new)
        return self.tree_reduce(np.asarray(accs, dtype=np.int32))

    def build(self) -> InstrStream:
        if not self._op:
            self.emit(NOP)
        return InstrStream(self.name,
                           np.concatenate(self._op),
                           np.concatenate(self._s1),
                           np.concatenate(self._s2))


# ---------------------------------------------------------------------------
# BLAS compilers (section 4.1 workloads)
# ---------------------------------------------------------------------------

def compile_ddot(n: int, schedule: str = "tree", accumulators: int = 8,
                 dot4: bool = False, fma: bool = False) -> InstrStream:
    """Inner product x.y - n muls (independent) + a reduction (fig. 5)."""
    b = _Builder(f"ddot{n}")
    if dot4:
        ids = b.emit_block(np.full(n // 4, DOT4), -1, -1)
        if n % 4:
            ids = np.append(ids, b.emit_block(np.full(1, DOT4), -1, -1))
        b.strided_reduce(ids, accumulators)
        return b.build()
    if fma:
        # FMAC chain: acc = fma(a_i, b_i, acc) - fully serial (LAP-PE mode).
        acc = b.emit(MUL, -1, -1)
        for _ in range(n - 1):
            acc = b.emit(FMA, -1, acc)
        return b.build()
    muls = b.emit_block(np.full(n, MUL), -1, -1)
    if schedule == "tree":
        b.tree_reduce(muls)
    elif schedule == "sequential":
        b.chain_reduce(muls)
    elif schedule == "strided":
        b.strided_reduce(muls, accumulators)
    else:
        raise ValueError(schedule)
    return b.build()


def compile_dgemv(m: int, n: int, schedule: str = "tree",
                  accumulators: int = 8) -> InstrStream:
    b = _Builder(f"dgemv{m}x{n}")
    for _ in range(m):
        muls = b.emit_block(np.full(n, MUL), -1, -1)
        if schedule == "tree":
            b.tree_reduce(muls)
        elif schedule == "sequential":
            b.chain_reduce(muls)
        else:
            b.strided_reduce(muls, accumulators)
    return b.build()


def _accumulate_group(b: _Builder, g: int, steps: int, op: int) -> None:
    """One register block of ``compile_dgemm``: ``g`` accumulators, each
    opened by an ``op`` and then, ``steps - 1`` times, a block of ``g`` new
    ``op`` products and a block of ``g`` adds of (accumulator, product).
    The reference emits it block by block; here the block's ids are
    computed at once (the same instructions, in the same order)."""
    base = b._n
    steps = max(int(steps), 1)
    code = np.full(g * (2 * steps - 1), op, np.int32)
    src1 = np.full(code.size, -1, np.int32)
    src2 = np.full(code.size, -1, np.int32)
    if steps > 1:
        lanes = np.arange(g)
        parts = g + 2 * g * np.arange(steps - 1)[:, None] + lanes
        adds = parts + g
        accs = np.concatenate([lanes[None, :], adds[:-1]])
        code[adds] = ADD
        src1[adds] = accs + base
        src2[adds] = parts + base
    b.emit_block(code, src1, src2)


def compile_dgemm(m: int, n: int, k: int, unroll: int = 4,
                  dot4: bool = False) -> InstrStream:
    """C = A B as m*n length-k inner products, register-blocked by ``unroll``.

    ``unroll`` C elements are kept in flight; their mul/add chains are
    interleaved round-robin, which is precisely the compiler hazard reduction
    the paper cites [23]: each accumulate sees its operand ``unroll`` issue
    slots later.
    """
    b = _Builder(f"dgemm{m}x{n}x{k}")
    cells = m * n
    u = max(1, int(unroll))
    for g0 in range(0, cells, u):
        g = min(u, cells - g0)
        if dot4:
            _accumulate_group(b, g, -(-k // 4), DOT4)
        else:
            _accumulate_group(b, g, k, MUL)     # t = 0 products, then k - 1
    return b.build()


# ---------------------------------------------------------------------------
# LAPACK compilers (section 4.2 workloads) - full dataflow fidelity: the
# current matrix is an SSA id table, so panel/trailing dependences are real.
# ---------------------------------------------------------------------------

def compile_dgeqrf(n: int, unroll: int = 4) -> InstrStream:
    """Householder QR of n-by-n (DGEQRF): serial sqrt/div on the panel path,
    GEMM-like trailing updates."""
    b = _Builder(f"dgeqrf{n}")
    ids = np.full((n, n), -1, dtype=np.int32)       # SSA id of each A entry
    for kcol in range(n - 1):
        m = n - kcol
        col = ids[kcol:, kcol]
        # ||x||^2: m squares + tree reduce. Depends on current column values.
        sq = b.emit_block(np.full(m, MUL), col, col)
        nrm2 = b.tree_reduce(sq)
        nrm = b.emit(SQRT, nrm2, -1)                 # serial: waits on reduce
        alpha = b.emit(ADD, int(col[0]), nrm)        # x0 + sign*||x||
        # v = x / alpha for the sub-diagonal entries: m-1 divisions, all
        # waiting on alpha (the paper's "always dependency ... that stalls").
        v = b.emit_block(np.full(m - 1, DIV), col[1:], alpha)
        v = np.concatenate([[alpha], v]).astype(np.int32)  # v0 ~ alpha slot
        tau = b.emit(DIV, nrm2, alpha)               # tau = beta path
        # Trailing update per column j > kcol, ``unroll`` columns in flight:
        for j0 in range(kcol + 1, n, unroll):
            cols = list(range(j0, min(j0 + unroll, n)))
            wids = []
            for j in cols:                           # w_j = v . A[:, j]
                prods = b.emit_block(np.full(m, MUL), v, ids[kcol:, j])
                wids.append(b.strided_reduce(prods, unroll))
            for j, w in zip(cols, wids):             # A[:,j] -= tau*v*w_j
                tw = b.emit(MUL, tau, w)
                upd = b.emit_block(np.full(m, MUL), v, tw)
                newc = b.emit_block(np.full(m, ADD), ids[kcol:, j], upd)
                ids[kcol:, j] = newc
    return b.build()


def compile_dgetrf(n: int, unroll: int = 4) -> InstrStream:
    """LU with partial pivoting (DGETRF). Pivot search compares run on the
    adder pipe (FP compare = subtract); column scaling is the serial div
    stream; trailing update is an outer product."""
    b = _Builder(f"dgetrf{n}")
    ids = np.full((n, n), -1, dtype=np.int32)
    for kcol in range(n - 1):
        m = n - kcol
        # pivot search: tree of compares over the column (adder pipe).
        piv = b.tree_reduce(ids[kcol:, kcol], opcode=ADD)
        # scale: l_ik = a_ik / pivot - all m-1 divs wait on the pivot compare.
        l = b.emit_block(np.full(m - 1, DIV), ids[kcol + 1:, kcol], piv)
        ids[kcol + 1:, kcol] = l
        # trailing update, ``unroll`` columns in flight:
        for j0 in range(kcol + 1, n, unroll):
            cols = list(range(j0, min(j0 + unroll, n)))
            for j in cols:
                prods = b.emit_block(np.full(m - 1, MUL), l, ids[kcol, j])
                newc = b.emit_block(np.full(m - 1, ADD), ids[kcol + 1:, j], prods)
                ids[kcol + 1:, j] = newc
    return b.build()


def compile_dpotrf(n: int, unroll: int = 4) -> InstrStream:
    """Cholesky (DPOTRF, lower): serial sqrt on the diagonal, divs per column."""
    b = _Builder(f"dpotrf{n}")
    ids = np.full((n, n), -1, dtype=np.int32)
    for kcol in range(n):
        d = b.emit(SQRT, ids[kcol, kcol], -1)
        ids[kcol, kcol] = d
        m = n - kcol - 1
        if m == 0:
            continue
        l = b.emit_block(np.full(m, DIV), ids[kcol + 1:, kcol], d)
        ids[kcol + 1:, kcol] = l
        for j in range(kcol + 1, n):                 # rank-1 trailing update
            rows = np.arange(j, n)
            prods = b.emit_block(np.full(rows.size, MUL), ids[j, kcol],
                                 ids[rows, kcol])
            newc = b.emit_block(np.full(rows.size, ADD), ids[rows, j], prods)
            ids[rows, j] = newc
    return b.build()


COMPILERS = {
    "ddot": compile_ddot,
    "dgemv": compile_dgemv,
    "dgemm": compile_dgemm,
    "dgeqrf": compile_dgeqrf,
    "dgetrf": compile_dgetrf,
    "dpotrf": compile_dpotrf,
}
