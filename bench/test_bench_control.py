"""The control of each cell's check, on the card: the plain reference put
in the program's place, in float32 with its matrix products in TF32 (the
step below the configurations' float32 with TF32 off), has to fail the
cell's limits, and the program on the same inputs has to pass them. At
64 items of the cell's own shapes. Marked ``cuda``: skips without a card.

    python -m pytest -q bench/test_bench_control.py
"""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import generate, harness  # noqa: E402

pytestmark = pytest.mark.cuda
ITEMS = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _judge(spec, cell, a, b, got, x):
    sols = harness._Solutions(x, 1)
    sols.add(x)
    return harness.check(spec.routine(spec.traffic(
        spec.cell(cell)["traffic"])["routine"]), a, b, got, sols,
        spec.limits(cell))


@pytest.mark.parametrize("cell", ["sq512_f32.posv", "tall512x256_f32.gels"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_program_passes_and_the_tf32_control_fails(card, cell, seed):
    from repro_torch import linalg
    spec = harness.Spec()
    config = dict(spec.config(spec.cell(cell)["config"]), batch=ITEMS)
    traffic = spec.traffic(spec.cell(cell)["traffic"])
    ref = spec.routine(traffic["routine"])
    a, b = generate.make_inputs(config, traffic, ref, seed, card)
    with linalg.use(policy=traffic["policy"]):
        res = getattr(linalg, traffic["factor"])(a)
        x = getattr(linalg, traffic["solve"])(res, b)
    program = _judge(spec, cell, a, b, harness._result_parts(res), x)
    assert program["ok"], program
    got = ref.factor(a, tf32=True)
    control = _judge(spec, cell, a, b, got, ref.solve(got, b, tf32=True))
    assert not control["ok"], control
    assert torch.backends.cuda.matmul.allow_tf32 is False
