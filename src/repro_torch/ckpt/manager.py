"""Checkpoint manager (port of ``repro.ckpt.manager``): interval policy,
keep-N GC, restore-latest."""
from __future__ import annotations

from typing import Optional

from repro_torch.ckpt import checkpoint


class CheckpointManager:
    def __init__(self, directory: str, save_interval: int = 100,
                 keep: int = 3):
        self.directory = directory
        self.save_interval = max(1, save_interval)
        self.keep = keep

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, state) -> str:
        return checkpoint.save(self.directory, step, state, keep=self.keep)

    def latest_step(self) -> Optional[int]:
        return checkpoint.latest_step(self.directory)

    def restore_latest(self, like):
        """Returns (state, step) or (None, -1) if no checkpoint exists."""
        if self.latest_step() is None:
            return None, -1
        return checkpoint.restore(self.directory, like)
