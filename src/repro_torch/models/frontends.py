"""Modality frontend stubs (port of ``repro.models.frontends``).

The reference specifies the transformer backbone only; the frontend hands
over precomputed frame (audio) or patch (vision) embeddings of width
d_model. :func:`frontend_spec` gives their ``(shape, dtype)``, the pair the
port's registry uses for a ``jax.ShapeDtypeStruct``, and
:func:`synthetic_frontend` draws matching random embeddings for smoke runs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

WHISPER_FRAMES = 1500          # 30 s of audio at the encoder's frame rate
INTERNVL_PATCHES = 256         # 448x448 / 14 patch / pixel-shuffle 0.5


def frontend_tokens(cfg: ModelConfig) -> int:
    if cfg.frontend == "audio":
        return cfg.encoder_seq or WHISPER_FRAMES
    if cfg.frontend == "vision":
        return cfg.num_prefix_tokens or INTERNVL_PATCHES
    return 0


def frontend_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16
                  ) -> Optional[Tuple[Tuple[int, int, int], torch.dtype]]:
    """((batch, frontend tokens, d_model), dtype), or None without a
    frontend."""
    n = frontend_tokens(cfg)
    if n == 0:
        return None
    return (batch, n, cfg.d_model), dtype


def synthetic_frontend(generator: torch.Generator, cfg: ModelConfig,
                       batch: int, dtype=torch.bfloat16,
                       device=None) -> torch.Tensor:
    """0.02 N(0, 1) embeddings of :func:`frontend_spec`'s shape, drawn from
    ``generator`` on ``device`` (default: the generator's)."""
    shape = (batch, frontend_tokens(cfg), cfg.d_model)
    device = generator.device if device is None else device
    return (0.02 * torch.randn(shape, generator=generator, device=device)
            ).to(dtype)
