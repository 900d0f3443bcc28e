"""Synthetic, deterministic, shardable data pipeline (port of
``repro.data.pipeline``).

Every (step, global position) maps to tokens through a counter-based hash
(SplitMix64), so any host can materialize exactly its shard of the global
batch with no coordination. The stream is not uniform noise: tokens
follow a periodic walk with rare hash resets, so a language model trained
on it has signal to fit. The tokens are the reference's, bitwise (the
same numpy arithmetic).

The frontend families' embeddings differ: the reference draws them from
``jax.random`` keyed by (seed, step); here they come from a CPU
``torch.Generator`` seeded by the same hash of (seed, step), the same
distribution (0.02 N(0, 1) in bf16) and the same values on every device.
``global_batch`` and ``make_batch``'s ``sharding`` (an array sharded over a
mesh) are left out until the distributed item (ROADMAP.md A.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_tokens, synthetic_frontend


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    pattern_period: int = 97          # learnable structure scale


class SyntheticDataset:
    """Deterministic token stream: ``tokens(step)[b, t]`` is a pure function
    of (seed, step, b, t)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _base(self, step: int) -> np.uint64:
        return (np.uint64(self.cfg.seed) * np.uint64(0x100000001B3)
                + np.uint64(step) * np.uint64(0x1000193))

    def tokens_slice(self, step: int, b0: int, b1: int,
                     t0: int = 0, t1: Optional[int] = None) -> np.ndarray:
        """Materialize rows [b0, b1) x cols [t0, t1) of the step's batch."""
        c = self.cfg
        t1 = c.seq_len if t1 is None else t1
        bs = np.arange(b0, b1, dtype=np.uint64)[:, None]
        ts = np.arange(t0, t1, dtype=np.uint64)[None, :]
        # slowly-varying walk + hash noise: predictable next-token structure
        walk = (bs * np.uint64(31) + ts * np.uint64(7)) % np.uint64(
            c.pattern_period)
        noise = _splitmix64(self._base(step) + bs * np.uint64(65537) + ts)
        mix = np.where((noise % np.uint64(13)) == 0, noise >> np.uint64(32),
                       walk)
        return (mix % np.uint64(c.vocab)).astype(np.int32)

    def local_batch(self, step: int) -> np.ndarray:
        return self.tokens_slice(step, 0, self.cfg.global_batch)

    def frontend_generator(self, step: int) -> torch.Generator:
        """A CPU generator seeded by the hash of (seed, step)."""
        seed = int(_splitmix64(np.array([self._base(step)], np.uint64))[0])
        return torch.Generator().manual_seed(seed & (2 ** 63 - 1))


def make_batch(cfg: ModelConfig, data: DataConfig, step: int,
               accum: int = 1, device="cuda") -> dict:
    """The model-facing batch dict on ``device`` (the card unless the
    caller asks for the CPU): {"tokens": int32 (B, S)} and, for the
    frontend families, {"frames" | "patches": bf16 (B, P, d)}; with
    ``accum`` > 1 each is reshaped to (accum, B / accum, ...)."""
    ds = SyntheticDataset(data)
    batch = {"tokens": torch.from_numpy(ds.local_batch(step))}
    if frontend_tokens(cfg):
        emb = synthetic_frontend(ds.frontend_generator(step), cfg,
                                 data.global_batch)
        batch["frames" if cfg.frontend == "audio" else "patches"] = emb
    if accum > 1:
        b = data.global_batch // accum
        batch = {k: t.reshape(accum, b, *t.shape[1:])
                 for k, t in batch.items()}
    return {k: t.to(device) for k, t in batch.items()}
