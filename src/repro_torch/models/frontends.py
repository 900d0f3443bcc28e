"""Modality frontend sizes (port of ``frontend_tokens`` and its constants
from ``repro.models.frontends``). The frontends themselves are stubs in the
reference too (precomputed frame / patch embeddings); the port's model
code does not run the vlm and audio families yet."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

WHISPER_FRAMES = 1500          # 30 s of audio at the encoder's frame rate
INTERNVL_PATCHES = 256         # 448x448 / 14 patch / pixel-shuffle 0.5


def frontend_tokens(cfg: ModelConfig) -> int:
    if cfg.frontend == "audio":
        return cfg.encoder_seq or WHISPER_FRAMES
    if cfg.frontend == "vision":
        return cfg.num_prefix_tokens or INTERNVL_PATCHES
    return 0
