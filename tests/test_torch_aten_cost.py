"""repro_torch.core.aten_cost: the aten-level counterpart of the
reference's trip-count-aware HLO cost (tests/test_hlo_cost.py's cases on
a dispatch mode), the memory it tracks, and the collectives it reads on a
fake world."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import aten_cost as ac

N = 128
EXPECT = 2 * N ** 3


def _run(fn, *args):
    """The Cost of ``fn(*args)`` run once under a CostMode."""
    with ac.CostMode() as mode:
        fn(*args)
    return mode.cost


def _cost(fn, *shapes, fake=True):
    """The Cost of ``fn`` on tensors of ``shapes`` (fake unless asked)."""
    if not fake:
        return _run(fn, *[torch.randn(s, generator=torch.Generator()
                                      .manual_seed(0)) for s in shapes])
    with FakeTensorMode():
        return _run(fn, *[torch.empty(s) for s in shapes])


@pytest.mark.parametrize("fake", [True, False], ids=["fake", "real"])
def test_single_product_exact(fake):
    c = _cost(lambda w, x: x @ w, (N, N), (N, N), fake=fake)
    assert c.flops == EXPECT
    assert c.bytes == c.bytes_fused == 3 * N * N * 4


@pytest.mark.parametrize("op,shapes,want", [
    ("bmm", [(4, 32, 16), (4, 16, 8)], 2 * 4 * 32 * 8 * 16),
    ("addmm", [(8,), (32, 16), (16, 8)], 2 * 32 * 8 * 16),
    ("baddbmm", [(4, 32, 8), (4, 32, 16), (4, 16, 8)], 2 * 4 * 32 * 8 * 16),
    ("linear", [(32, 16), (8, 16), (8,)], 2 * 32 * 8 * 16),
    ("conv2d", [(2, 3, 10, 10), (5, 3, 3, 3)], 2 * 2 * 5 * 8 * 8 * 27),
])
def test_products(op, shapes, want):
    fn = getattr(torch, op, None) or getattr(torch.nn.functional, op)
    assert _cost(fn, *shapes).flops == want


def test_python_loop_counts_every_iteration():
    """The counterpart of test_xla_undercounts_scan_we_do_not: the port's
    loops unroll in Python, so 8 products cost 8 products."""
    def loop(w, x):
        for _ in range(8):
            x = x @ w
        return x
    assert _cost(loop, (N, N), (N, N)).flops == 8 * EXPECT


def test_nested_loops():
    def nested(w, x):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x
    assert _cost(nested, (N, N), (N, N)).flops == 12 * EXPECT


def test_remat_recompute_visible():
    """A checkpointed block's backward recomputes its forward: the gradient
    costs more than 1.5x the forward's products, as in the reference."""
    def fwd(w, x):
        return torch.sum(torch.tanh(x @ w) @ w)

    def grad(w, x):
        x.requires_grad_(True)
        y = torch.utils.checkpoint.checkpoint(
            lambda a: torch.tanh(a @ w), x, use_reentrant=False)
        return torch.autograd.grad(torch.sum(y @ w), x)

    f = _cost(fwd, (N, N), (N, N)).flops
    g = _cost(grad, (N, N), (N, N)).flops
    assert g > 1.5 * f
    # forward 2 products, recompute 1, backward 2 (the input's grads)
    assert g == pytest.approx(5 * EXPECT, rel=0.01)


def test_elementwise_chain():
    """The reference's test_fusion_flops_counted_bytes_boundary_only: every
    elementwise op and the reduction counted (n <= flops <= 10n); the
    fused-traffic bytes keep none of the chain (it fuses into a product's
    epilogue), within the reference's 6 n words; the every-op bytes are
    each op's operands and result: exp 2n, mul 3n, add 2n, sum n + 1."""
    n = N * N
    c = _cost(lambda x: torch.sum(torch.exp(x) * x + 1.0), (N, N))
    assert n <= c.flops <= 10 * n
    assert c.flops == 4 * n
    assert c.bytes_fused <= 6 * n * 4 and c.bytes_fused == 0
    assert c.bytes == (8 * n + 1) * 4


@pytest.mark.parametrize("how", ["copy_view", "index_copy", "index_put"])
def test_inplace_cache_write_costs_twice_the_update(how):
    cache_shape, upd_shape = (4, 1024, 8, 64), (4, 1, 8, 64)

    def write(cache, upd):
        if how == "copy_view":
            cache[:, 5:6] = upd
        elif how == "index_copy":
            cache.index_copy_(1, torch.tensor([5]), upd)
        else:
            cache.index_put_((torch.tensor([1]),), upd[0])

    c = _cost(write, cache_shape, upd_shape)
    upd = 4 * 8 * 64 * 4 if how != "index_put" else 8 * 64 * 4
    assert c.bytes == c.bytes_fused == 2 * upd
    assert c.flops == 0


def test_gather_reads_what_it_writes():
    with FakeTensorMode():
        t = torch.empty(1000, 64)
        i = torch.empty(10, dtype=torch.int64)
        c = _run(lambda: t.index_select(0, i))
    assert c.bytes == c.bytes_fused == 2 * 10 * 64 * 4


def test_views_are_free():
    c = _cost(lambda x: x.view(N * N).reshape(N, N).transpose(0, 1)[3:5],
              (N, N))
    assert (c.flops, c.bytes, c.bytes_fused) == (0.0, 0.0, 0.0)


def test_cost_arithmetic():
    a = ac.Cost(1.0, 2.0, 3.0, {"all-gather": 4.0})
    a += ac.Cost(1.0, 1.0, 1.0, {"all-gather": 1.0, "all-reduce": 2.0})
    assert (a.flops, a.bytes, a.bytes_fused) == (2.0, 3.0, 4.0)
    assert a.coll == {"all-gather": 5.0, "all-reduce": 2.0}
    assert a.collective_bytes == 7.0
    s = a.scaled(2)
    assert (s.flops, s.collective_bytes) == (4.0, 14.0)


def test_memory_peak_and_release():
    with FakeTensorMode():
        mode = ac.CostMode()
        with mode:
            x = torch.empty(1000)                 # 4000 B
            y = x * 2                             # +4000
            v = y.view(10, 100)                   # a view: nothing new
            z = v + 1                             # +4000: peak 12000
            del y, v                              # y's storage dies
            w = z.sum()                           # +4
        assert mode.peak == 12000
        assert mode.live == 8004
        del x, z, w
        assert mode.live == 0
    assert mode.ops["aten::add.Tensor"][0] == 1


def test_host_read_stand_in():
    """A fake tensor's host read gets the analyzer's stand-in and counts; a
    real tensor's is read."""
    from repro_torch.analysis.fake_card import stand_in
    with FakeTensorMode():
        with ac.CostMode() as mode:
            n = torch.empty(3, dtype=torch.int64).sum().item()
            f = torch.empty(3).sum().item()
    assert (n, f) == (stand_in(torch.int64), stand_in(torch.float32))
    assert mode.host_reads == 2
    with ac.CostMode() as mode:
        n = torch.full((3,), 7, dtype=torch.int64).sum().item()
    assert n == 21 and mode.host_reads == 0


_FAKE_WORLD = textwrap.dedent("""
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.aten_cost import CostMode
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.mesh import make_mesh

    init_fake_world(4)
    mesh = make_mesh((4,), ("x",), "cpu")
    with FakeTensorMode(), coll.record_transport() as rec:
        mode = CostMode()
        with mode:
            g = coll.all_gather_cat(torch.empty(8, 16), mesh, "x", 1)
            r = coll.reduce_scatter_chunk(torch.empty(16, 16), mesh, "x", 0)
            a = coll.all_reduce(torch.empty(4, 4), mesh, "x",
                                torch.distributed.ReduceOp.SUM)
        shapes = [list(t.shape) for t in (g, r, a)]
    records = {}
    for t in rec:
        records[t.kind] = records.get(t.kind, 0) + t.bytes
    print(json.dumps({"coll": mode.cost.coll, "records": records,
                      "shapes": shapes, "bytes": mode.cost.bytes}))
""")


def test_collectives_on_a_fake_world():
    """An all-gather, a reduce-scatter and an all-reduce of known shapes on
    a fake world of 4 (a subprocess): operand bytes per participant under
    the reference's kind names, equal to what collectives' own transport
    records say."""
    r = subprocess.run([sys.executable, "-c", _FAKE_WORLD],
                       env=dict(os.environ, PYTHONPATH="src"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["shapes"] == [[8, 64], [4, 16], [4, 4]]
    assert out["coll"] == {"all-gather": 8 * 16 * 4,
                           "reduce-scatter": 16 * 16 * 4,
                           "all-reduce": 4 * 4 * 4}
    assert out["records"] == {"all_gather": 8 * 16 * 4,
                              "reduce_scatter": 16 * 16 * 4,
                              "all_reduce": 4 * 4 * 4}
    # HBM side: each collective's operand and result buffers
    assert out["bytes"] > sum(out["coll"].values())
