"""The port's hand-written kernels, by name, read from its sources.

A device kernel counts as hand-written when its name is a ``__global__``
function of one of the port's ``csrc/*.cu`` files, or a ``@triton.jit``
function of one of its modules; everything else the card runs (PyTorch's
own kernels, cuBLAS, copies and fills) is eager glue. The names are read
from the port's files at run time, so a kernel that a later change adds
is classed with no change here. The file stem names the kernel family:
``gemm`` is B1 (and B3), ``trsm_gemm`` is B2.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

_GLOBAL = re.compile(
    r"__global__\s+(?:void\s+)?"
    r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*[(<]")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def handwritten(package_dir: str) -> Dict[str, str]:
    """{kernel function name: source stem} over the port's package."""
    names: Dict[str, str] = {}
    csrc = os.path.join(package_dir, "csrc")
    if os.path.isdir(csrc):
        for f in sorted(os.listdir(csrc)):
            if f.endswith(".cu"):
                with open(os.path.join(csrc, f)) as fh:
                    for name in _GLOBAL.findall(fh.read()):
                        names[name] = f[:-3]
    for dirpath, _, files in os.walk(package_dir):
        for f in sorted(files):
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                if "triton.jit" in text:
                    for name in _TRITON.findall(text):
                        names[name] = f[:-3]
    return names


class Classifier:
    """Maps a device event's name to the stem of the hand-written kernel it
    runs, or None for eager glue. Profiler names are demangled signatures
    (``void trsm_gemm_batched_kernel<float, float>(Params)``): a kernel
    matches on its function name as a whole word."""

    def __init__(self, names: Dict[str, str]):
        self.names = names
        alts = "|".join(sorted(map(re.escape, names), key=len, reverse=True))
        self._re = re.compile(rf"(?<!\w)({alts})(?!\w)") \
            if names else None
        self._cache: Dict[str, Optional[str]] = {}

    def stem(self, event_name: str) -> Optional[str]:
        if event_name not in self._cache:
            m = self._re.search(event_name) if self._re else None
            self._cache[event_name] = self.names[m.group(1)] if m else None
        return self._cache[event_name]
