"""Fault tolerance: restart policy, heartbeat, straggler detection (a copy
of ``repro.runtime.fault_tolerance``: host code, no JAX in it).

Designed for the 1000+-node regime and exercised here single-host:

  * ``run_with_restarts`` - supervises a training loop; on failure it
    restores the latest atomic checkpoint and resumes (bounded restarts,
    exponential backoff). Node loss on a real cluster surfaces as exactly
    this: the job restarts from the last checkpoint on the surviving+replaced
    nodes (elastic_restore covers a changed mesh).
  * ``Heartbeat`` - per-step liveness file; an external supervisor (or the
    included ``watchdog``) detects a wedged job by heartbeat age.
  * ``StragglerDetector`` - per-step wall-time EWMA + deviation; steps slower
    than ``threshold`` x the running median are flagged with their step index
    (on a cluster: rank). Persistent stragglers trigger a report so the
    scheduler can evict the slow host - mitigation is *detection + restart
    without the bad node*, the standard large-fleet pattern.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised by tests/examples to emulate a node loss."""


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed: bool
    resume_steps: List[int]


def run_with_restarts(make_loop: Callable[[Optional[int]], int],
                      max_restarts: int = 3,
                      backoff_s: float = 0.0) -> RestartReport:
    """``make_loop(resume_step)`` runs training until done (returns final
    step) or raises. On exception we restart from the latest checkpoint
    (the loop itself restores state via its CheckpointManager)."""
    restarts = 0
    resume_steps: List[int] = []
    while True:
        try:
            make_loop(None if not resume_steps else resume_steps[-1])
            return RestartReport(restarts, True, resume_steps)
        except (SimulatedFailure, RuntimeError) as e:  # noqa: PERF203
            restarts += 1
            if restarts > max_restarts:
                return RestartReport(restarts - 1, False, resume_steps)
            resume_steps.append(getattr(e, "step", -1))
            if backoff_s:
                time.sleep(backoff_s * (2 ** (restarts - 1)))


class Heartbeat:
    def __init__(self, path: str):
        self.path = path

    def beat(self, step: int) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["time"]
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def is_stale(self, timeout_s: float) -> bool:
        age = self.age()
        return age is None or age > timeout_s


class StragglerDetector:
    """Flags steps (ranks, on a cluster) whose duration exceeds
    ``threshold`` x running median over a sliding window."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.durations: List[float] = []
        self.flagged: List[int] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, duration_s: float) -> bool:
        hist = self.durations[-self.window:]
        self.durations.append(duration_s)
        if len(hist) >= 5:
            med = float(np.median(hist))
            if duration_s > self.threshold * med:
                self.flagged.append(step)
                return True
        return False

    def report(self) -> dict:
        d = np.asarray(self.durations) if self.durations else np.zeros(1)
        return {"steps": len(self.durations),
                "median_s": float(np.median(d)),
                "p95_s": float(np.percentile(d, 95)),
                "flagged": list(self.flagged)}
