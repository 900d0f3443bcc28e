"""repro_torch.core.isa against repro.core.isa: every compiler's instruction
stream bitwise (opcode, src1, src2 as int32), its name, size, flops and the
two censuses, over a grid of sizes (1 and odd ones among them), schedules,
accumulator counts, unroll factors and the DOT4 / FMA forms."""
import itertools

import numpy as np
import pytest

from repro.core import isa as jisa
from repro_torch.core import isa as tisa


def _same(t, j):
    assert t.name == j.name
    for field in ("opcode", "src1", "src2"):
        got, want = getattr(t, field), getattr(j, field)
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert (t.n_instructions, t.flops) == (j.n_instructions, j.flops)
    assert t.census() == j.census()
    for window in (1, 2, 5):
        assert t.hazard_census(window) == j.hazard_census(window)


def test_isa_constants_equal_reference():
    names = ("NOP", "MUL", "ADD", "DIV", "SQRT", "FMA", "DOT4", "N_OPCODES",
             "OPCODE_NAMES", "OPCODE_FLOPS")
    for name in names:
        assert getattr(tisa, name) == getattr(jisa, name), name
    assert sorted(tisa.COMPILERS) == sorted(jisa.COMPILERS)


DDOT = list(itertools.product(
    [1, 2, 7, 64, 129], ["tree", "sequential", "strided"], [1, 3, 8]))


@pytest.mark.parametrize("n,schedule,acc", DDOT)
def test_ddot_stream_bitwise(n, schedule, acc):
    _same(tisa.compile_ddot(n, schedule=schedule, accumulators=acc),
          jisa.compile_ddot(n, schedule=schedule, accumulators=acc))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 64, 130])
@pytest.mark.parametrize("form", ["dot4", "fma"])
def test_ddot_dot4_and_fma_streams_bitwise(n, form):
    kw = {form: True}
    _same(tisa.compile_ddot(n, accumulators=3, **kw),
          jisa.compile_ddot(n, accumulators=3, **kw))


@pytest.mark.parametrize("m,n", [(1, 1), (3, 7), (5, 16)])
@pytest.mark.parametrize("schedule", ["tree", "sequential", "strided"])
def test_dgemv_stream_bitwise(m, n, schedule):
    _same(tisa.compile_dgemv(m, n, schedule=schedule, accumulators=3),
          jisa.compile_dgemv(m, n, schedule=schedule, accumulators=3))


@pytest.mark.parametrize("mnk", [(1, 1, 1), (3, 3, 8), (2, 5, 7), (4, 4, 13),
                                 (2, 3, 0), (0, 4, 5), (5, 5, 4)])
@pytest.mark.parametrize("unroll", [1, 3, 4])
@pytest.mark.parametrize("dot4", [False, True])
def test_dgemm_stream_bitwise(mnk, unroll, dot4):
    _same(tisa.compile_dgemm(*mnk, unroll=unroll, dot4=dot4),
          jisa.compile_dgemm(*mnk, unroll=unroll, dot4=dot4))


@pytest.mark.parametrize("routine", ["dgeqrf", "dgetrf", "dpotrf"])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("unroll", [1, 4])
def test_lapack_stream_bitwise(routine, n, unroll):
    _same(tisa.COMPILERS[routine](n, unroll=unroll),
          jisa.COMPILERS[routine](n, unroll=unroll))


def test_stream_reductions_bitwise():
    """The three reduction schedules of ``_Builder`` on one id vector each,
    after a hand-emitted prefix, and an empty stream's single NOP."""
    for n in (1, 2, 5, 33):
        for method, kw in (("tree_reduce", {}), ("chain_reduce", {}),
                           ("strided_reduce", {"accumulators": 4})):
            streams = []
            for mod in (tisa, jisa):
                b = mod._Builder("b")
                ids = b.emit_block(np.full(n, mod.MUL), -1, -1)
                b.emit(mod.DIV, int(ids[0]), -1)
                root = getattr(b, method)(ids[::-1], **kw)
                streams.append((root, b.build()))
            assert streams[0][0] == streams[1][0]
            _same(streams[0][1], streams[1][1])
    _same(tisa._Builder("empty").build(), jisa._Builder("empty").build())


def test_n48_streams_bitwise():
    """The n = 48 streams chip_smoke.py checks against the plain version,
    bitwise the reference's (the n = 100 ones are the same code)."""
    for t, j in ((tisa.compile_dgemm(48, 48, 48, unroll=4),
                  jisa.compile_dgemm(48, 48, 48, unroll=4)),
                 (tisa.compile_dgeqrf(48), jisa.compile_dgeqrf(48)),
                 (tisa.compile_dgetrf(48), jisa.compile_dgetrf(48)),
                 (tisa.compile_dgemm(48, 48, 48, dot4=True),
                  jisa.compile_dgemm(48, 48, 48, dot4=True))):
        _same(t, j)


def _package_names(pkg):
    """The names a package's ``__init__`` binds by its import statements
    (``dir()`` would also list submodules other tests import later)."""
    import ast
    import os
    tree = ast.parse(open(os.path.join(os.path.dirname(pkg.__file__),
                                       "__init__.py")).read())
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


def test_core_package_exports_reference_names():
    """repro_torch.core exports repro.core's names, with fx_census for
    jaxpr_census, from_trace for from_compiled (no XLA-compiled step) and
    aten_cost, the traced step's pricing, beside them."""
    import repro.core as jcore
    import repro_torch.core as tcore
    want = _package_names(jcore) - {"jaxpr_census", "from_compiled"} \
        | {"fx_census", "from_trace", "aten_cost"}
    assert _package_names(tcore) == want
    assert all(hasattr(tcore, name) for name in want)
