"""Read a ``torch.profiler`` trace of whole requests: the device's busy
time, its kernels by name, and its idle gaps by what the host was doing.

Frozen from ``chip_smoke.py``'s ``profile_call``: the device records are
read straight from the trace's kineto events (``key_averages`` builds a
Python object per event first), and a few tiny kernels run inside the
trace before the window, since the first kernel records of a trace on the
card can be lost or skewed. Beyond that reader, the window is the span of
a ``record_function`` range (so host and device times share the trace's
clock), busy time is the union of the device intervals inside it (not
their sum), and each idle gap is named by the innermost host range open
at its midpoint, under the benchmark's own range for the call.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "bench.window"
CALL_PREFIX = "bench.call."
PAD_KERNELS = 8
TOP = 10


@contextlib.contextmanager
def traced(device: torch.device) -> Iterator[object]:
    """A profiler over the host and, on a card, the device; the padding
    kernels run first. Yields the profiler, read by :func:`read` after
    the block."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        filler = torch.zeros(1, device=device)
        for _ in range(PAD_KERNELS if device.type == "cuda" else 0):
            filler.add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        yield prof


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Covering:
    """The innermost of a set of host ranges open at a time."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: int, depth: int = 512) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - depth, -1), -1):
            s, e, name = self.ranges[j]
            if e >= t:
                return name
        return None


def read(prof) -> Dict:
    """The window's device summary: ``window_s``, ``busy_s``, ``kernels``
    ({name: [seconds, launches]}), ``device_ops`` (the ``TOP`` kernels by
    time) and ``idle_gaps`` (the ``TOP`` host activities by idle seconds,
    each "call > host op")."""
    from torch.autograd import DeviceType
    window = None
    calls: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the host ranges also appear on the device's timeline as
            # annotations; they are not device work
            annotation = name == WINDOW or name.startswith(CALL_PREFIX) or \
                getattr(e, "is_user_annotation", lambda: False)()
            if dur > 0 and not annotation:
                dev.append((start, start + dur, name))
            continue
        if name == WINDOW:
            window = (start, start + dur)
        elif name.startswith(CALL_PREFIX):
            calls.append((start, start + dur, name[len(CALL_PREFIX):]))
        else:
            host.append((start, start + dur, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    kernels: Dict[str, List[float]] = {}
    inside = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        acc = kernels.setdefault(name, [0.0, 0])
        acc[0] += (e - s) * 1e-9
        acc[1] += 1
    merged = _merge(inside)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps: Dict[str, float] = {}
    call_at, host_at = _Covering(calls), _Covering(host)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = f"{call_at.at(mid) or 'between calls'} > " \
               f"{host_at.at(mid) or 'python'}"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    top = lambda d, key: sorted(d.items(), key=key, reverse=True)[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy, "kernels": kernels,
            "device_ops": [[k[:120], v[0]] for k, v in
                           top(kernels, lambda kv: kv[1][0])],
            "idle_gaps": [[k[:120], v] for k, v in
                          top(gaps, lambda kv: kv[1])]}
