"""The fake card's indexing bindings held to PyTorch's own.

On a build of PyTorch without CUDA the analyzer traces fake CUDA tensors
through ``repro_torch.analysis.fake_card.patched_bindings``: four
``Tensor`` bindings (``__getitem__``, ``__setitem__``, ``contiguous``,
``copy_``) spelled out in aten ops. Here the same trace runs twice on fake
CPU tensors, where PyTorch's own bindings work: once as they are, once
through the patched ones (made to take fake CPU tensors too). The two aten
graphs must be equal node for node (op, target, output shape, scalar
arguments): every surface routine at the surface sizes under the
``model`` policy in f32, and a set of indexing forms beyond what the port
uses.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import linalg
from repro_torch.analysis import fake_card, report

CPU = torch.device("cpu")


def _signature(gm):
    out = []
    for node in gm.graph.nodes:
        val = node.meta.get("val")
        args = tuple(a if isinstance(a, (int, float, bool, type(None)))
                     else type(a).__name__ for a in node.args)
        out.append((node.op,
                    str(node.target) if node.op == "call_function" else "",
                    tuple(val.shape) if isinstance(val, torch.Tensor)
                    else None, args))
    return out


def _patched(monkeypatch):
    """Route fake CPU tensors through the patched bindings."""
    monkeypatch.setattr(fake_card, "needs_patched_bindings", lambda d: True)
    monkeypatch.setattr(fake_card, "_fake_cuda",
                        lambda t: isinstance(t, FakeTensor))


def _both(monkeypatch, fn, args, kw=None):
    own = fake_card.trace(fn, args, kw or {}, CPU)
    with monkeypatch.context() as m:
        _patched(m)
        patched = fake_card.trace(fn, args, kw or {}, CPU)
    return _signature(own.graph), _signature(patched.graph)


@pytest.mark.parametrize("name", report.surface_routines())
def test_surface_graph_equals_torchs_own_indexing(monkeypatch, name):
    args, kw = report._surface_args(name)
    with linalg.use(device="cpu", policy="model"):
        own, patched = _both(monkeypatch, getattr(linalg, name), args, kw)
    assert len(own) == len(patched)
    for i, (a, b) in enumerate(zip(own, patched)):
        assert a == b, f"{name}: node {i}: torch {a}, patched {b}"


def _reads(x):
    return (x[1:, None, ::2], x[..., 1], x[-1], x[0:100], x[:],
            x[:, [0, 2]], x[[1, 2], 1:], x[...], x[True], x[False],
            x[1:2, True], x[:, -2:], x[-3:-1], x[1, ..., None],
            x[[0, 1, 3]], x[torch.tensor([2, 0])], x.t().contiguous(),
            x.contiguous())


def _writes(x):
    y = x.clone()
    y[1, 2] = 0.5                       # 0-d destination
    y[1] = 0.25                         # a row from a Python scalar
    y[2] = x[0, 0]                      # a row from a 0-d tensor
    y[1, :3] = x[2, :3]
    y[1:2, :3] = x[2:3, :3].unsqueeze(0)   # leading 1s dropped
    y[:, 1:3] = x[0, 1:3]               # broadcast
    y[[0, 2], 1:3] = 1.0
    y[[1, 2], :3] = x[2:4, :3].unsqueeze(0)
    y[:, torch.tensor([1, 0])] = x[:, :2]
    y[:] = y * 2
    y[0:100] = x
    y[False] = 3.0
    z = torch.empty_like(x.t())
    z.copy_(x.t())
    return y, z


@pytest.mark.parametrize("forms", [_reads, _writes], ids=["reads", "writes"])
def test_indexing_forms_equal_torchs_own(monkeypatch, forms):
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    own, patched = _both(monkeypatch, forms, (x,))
    assert own == patched


@pytest.mark.parametrize("step, message", [
    (-1, "step must be greater than zero"), (0, "slice step cannot be zero")])
def test_non_positive_step_raises_as_torch(monkeypatch, step, message):
    x = np.zeros((4, 5), np.float32)

    def fn(t):
        return t[::step]
    with pytest.raises(ValueError, match=message):
        fake_card.trace(fn, (x,), {}, CPU)
    with monkeypatch.context() as m:
        _patched(m)
        with pytest.raises(ValueError, match=message):
            fake_card.trace(fn, (x,), {}, CPU)
