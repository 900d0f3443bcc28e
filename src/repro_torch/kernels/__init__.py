"""repro_torch.kernels - hand-written Hopper kernels with their plain versions.

==========================  =====================  ==========================
wrapper                     CUDA source            replaces (Pallas, TPU)
==========================  =====================  ==========================
``gemm.gemm``               ``csrc/gemm.cu``       ``repro/kernels/gemm.py::gemm``
``fused.gemm_bias_act``     ``csrc/gemm.cu``       ``repro/kernels/fused.py::gemm_bias_act``
``fused.trsm_gemm``         ``csrc/trsm_gemm.cu``  ``repro/kernels/fused.py::trsm_gemm``
==========================  =====================  ==========================

Kernels are built at first use (:mod:`repro_torch.kernels._build`); a
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors.
"""
