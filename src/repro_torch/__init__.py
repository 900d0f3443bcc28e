"""repro_torch - the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module (``arch``, ``core``, ``obs``, ``tune``,
``kernels``, ``blas``, ``lapack``, ``linalg``) and replaces every Pallas
TPU kernel on the main path with a hand-written CUDA kernel for
``sm_90a`` (sources under ``repro_torch/csrc/``, built at first use).

It imports ``torch`` and never ``jax`` or ``repro``. The public API is
:mod:`repro_torch.linalg`; its routines run on ``cuda`` unless the
context asks for the CPU (``linalg.use(device="cpu")``), where every
kernel wrapper runs its plain PyTorch version instead.
"""
