"""Unified model API (port of ``repro.models.model_zoo``): init / forward /
prefill / init_caches / decode_step / param_count over the dense, ssm and
hybrid families.

The entry points run on the device the model lives on, which
:func:`init` puts on ``cuda`` unless the caller asks for the CPU; on the
card the full-sequence paths (forward, prefill) run kernels B5 and B6 in
every layer that has attention or an SSM. They run under
``torch.no_grad()``: this slice serves, and the kernels have no backward
yet. Building an encoder-decoder, moe or vlm model raises
``NotImplementedError`` naming the ROADMAP item that ports it. The ``cfg``
arguments mirror the reference's signatures; the model carries its own.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> LM:
    """The model of ``cfg`` on ``device`` with the reference's shapes and
    distributions (truncated normal at +-2 sigma scaled as the reference,
    ones / zeros / log-spaced decays where it has them), drawn from
    ``generator`` (default: a fresh one seeded 0 on ``device``). The values
    differ from the JAX package's for the same seed: see
    :mod:`repro_torch.models.convert` to carry them across."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.models.init builds on 'cuda' by "
                           "default and no CUDA device is available; ask "
                           "for the CPU with device='cpu'")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = LM(cfg, device=device)
    for module in model.modules():
        reset = getattr(module, "reset", None)
        if reset is not None:
            reset(generator)
    return model


@torch.no_grad()
def forward(model: LM, batch: dict, cfg: ModelConfig):
    """batch: {'tokens': (B, S)}. Returns (logits, aux)."""
    logits = model(batch["tokens"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


@torch.no_grad()
def prefill(model: LM, batch: dict, cfg: ModelConfig):
    """Returns (logits, aux, caches): caches are the stacked per-layer KV
    of a dense model, None for ssm and hybrid (as in the reference)."""
    logits, kv = model.prefill(batch["tokens"])
    return (logits, torch.zeros((), dtype=torch.float32,
                                device=logits.device), kv)


def init_caches(model: LM, cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    return model.init_caches(batch, max_len, dtype)


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, cfg: ModelConfig, caches,
                cache_index: int):
    """token (B, 1) -> (logits (B, 1, V), caches updated in place)."""
    return model.decode_step(token, caches, cache_index)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from the module built on the meta device (no
    allocation)."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())
