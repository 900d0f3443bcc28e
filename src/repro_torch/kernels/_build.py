"""Build and load the CUDA kernels: nvcc into shared libraries, ctypes to bind.

Each source under ``repro_torch/csrc/`` (``gemm.cu``, ``trsm_gemm.cu``,
``dotp.cu``, ``flash_attention.cu``, ``ssd_scan.cu``, ``fpu_chain.cu``)
compiles on its own, at first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``build/repro_torch/<stem>-<hash>.so`` at the root of the checkout.
The hash covers the source, the shared headers and the flags, so an
edited kernel rebuilds and an unchanged one loads from the cache.
:func:`build_all` starts one ``nvcc`` per source, all together, and waits
for them. The libraries have a plain C interface: every pointer and the
stream are passed as ``ctypes.c_void_p``, and every entry point returns the
``cudaError_t`` of its launch, which the wrappers raise on.

Nothing here falls back: a missing ``nvcc`` or a failed build raises
:class:`BuildError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
ROOT = os.path.dirname(os.path.dirname(_PKG))        # checkout root (src/..)
BUILD_DIR = os.path.join(ROOT, "build", "repro_torch")
SOURCES = ("gemm", "trsm_gemm", "dotp", "flash_attention", "ssd_scan",
           "fpu_chain")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    "gemm": {
        "repro_gemm": ([I, I, I, I, I, I, P, LL, LL, P, LL, LL, P, LL, I, I,
                        I, P], I),
        "repro_gemm_bias_act": (
            [I, I, I, I, I, I, P, LL, LL, P, LL, LL, P, I, P, LL, I, I, I, P],
            I),
        "repro_gemv": ([I, I, P, LL, P, LL, LL, P, I, P, I, P, LL, I, I, I,
                        P], I),
    },
    "trsm_gemm": {
        "repro_trsm_gemm": ([I, I, I, P, LL, LL, P, LL, LL, P, LL, LL, P,
                             LL, LL, P, P, P, P, I, I, I, I, I, I, I, P], I),
        "repro_trsm_gemm_co_resident": ([I, I], I),
    },
    "dotp": {
        "repro_dotp": ([I, I, P, LL, P, LL, LL, I, P, P, P, P], I),
        "repro_dotp_blocks_per_sm": ([I, I], I),
    },
    "flash_attention": {
        "repro_attention": ([I, I, P, LL, LL, LL, LL, P, LL, LL, LL, LL,
                             P, LL, LL, LL, LL, P, LL, LL, LL, LL,
                             I, I, I, I, I, I, F, I, LL, LL, I, P], I),
    },
    "ssd_scan": {
        "repro_ssd_scan": ([I, P, LL, LL, LL, LL, I, P, LL, LL, LL,
                            P, LL, LL, LL, LL, I, P, LL, LL, LL, LL, I,
                            P, LL, LL, LL, LL, I, I, I, I, I, I, I,
                            P, P, P, P, P], I),
        "repro_ssd_scan_smem_bytes": ([I, I, I, I, I], LL),
    },
    "fpu_chain": {
        "repro_fpu_chain": ([I, P, F, I, P, P, P], I),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """The CUDA toolchain is missing or a kernel failed to compile."""


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); :class:`BuildError` when neither has it."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise BuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the repro_torch "
        "CUDA kernels are built from repro_torch/csrc at first use and need "
        "the CUDA toolkit (tensors on the CPU use the plain versions "
        "instead)")


def _library_path(stem: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        if name == f"{stem}.cu" or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _start(stem: str, out: str):
    """Start one nvcc writing to a temporary name; :func:`_finish` moves it
    into place, so a cut-off build never leaves a library behind."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(proc, tmp: str, out: str, cmd: List[str]) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}): "
                         f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def build_all(stems: Iterable[str] = SOURCES) -> List[str]:
    """Build every missing library in parallel (one nvcc per source);
    returns the library paths."""
    paths = {s: _library_path(s) for s in stems}
    with _lock:
        procs = [_start(s, p) for s, p in paths.items()
                 if not os.path.exists(p)]
        errors = []
        for started in procs:
            try:
                _finish(*started)
            except BuildError as e:
                errors.append(str(e))
        if errors:
            raise BuildError("\n\n".join(errors))
    return list(paths.values())


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu`` with its argtypes set,
    building it first if the cache lacks it."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    (path,) = build_all([stem])
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in SIGNATURES[stem].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _libs[stem] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
