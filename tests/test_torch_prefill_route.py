"""``model_zoo.prefill(..., use_kernels=False)``, the reference's
``use_pallas=False`` and the dry run's route: on the CPU it is the default
route, so its logits, aux and caches are the default call's bitwise (the
card test in tests/test_torch_cuda.py shows it launches no kernel there).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.train import reduce_config
from repro_torch.models import model_zoo


def _cfg(arch):
    cfg = dataclasses.replace(reduce_config(
        registry.get_config(arch), layers=2, d_model=64, vocab=256, heads=4),
        dtype="float32")
    return dataclasses.replace(cfg, window=32) if cfg.window else cfg


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small",
                                  "minitron-8b", "qwen3-moe-235b-a22b"])
def test_use_kernels_false_is_the_default_route_on_cpu(arch):
    cfg = _cfg(arch)
    model = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 160), generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=g)
    want = model_zoo.prefill(model, batch, cfg)
    got = model_zoo.prefill(model, batch, cfg, use_kernels=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if want[2] is None:
        assert got[2] is None
    elif isinstance(want[2], dict):
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])
    else:
        assert torch.equal(got[2], want[2])


def test_use_kernels_true_on_cpu_raises():
    cfg = _cfg("minitron-8b")
    model = model_zoo.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="use_kernels=True"):
        model_zoo.prefill(model, {"tokens": torch.zeros((1, 8),
                                                        dtype=torch.int64)},
                          cfg, use_kernels=True)
