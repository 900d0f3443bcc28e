"""repro_torch.kernels - hand-written Hopper kernels with their plain versions.

==============================  =============================  ==========================================
wrapper                         CUDA source                    replaces (Pallas, TPU)
==============================  =============================  ==========================================
``gemm.gemm``                   ``csrc/gemm.cu``               ``repro/kernels/gemm.py::gemm``
``fused.gemm_bias_act``         ``csrc/gemm.cu``               ``repro/kernels/fused.py::gemm_bias_act``
``fused.trsm_gemm``             ``csrc/trsm_gemm.cu``          ``repro/kernels/fused.py::trsm_gemm``
``dotp.dotp``                   ``csrc/dotp.cu``               ``repro/kernels/dotp.py::dotp``
``flash_attention.attention``   ``csrc/flash_attention.cu``    ``repro/kernels/flash_attention.py::attention``
``ssd_scan.ssd_scan``           ``csrc/ssd_scan.cu``           ``repro/kernels/ssd_scan.py::ssd_scan``
==============================  =============================  ==========================================

Two kernels replace jitted JAX programs, not Pallas kernels:
``fpu_chain.fpu_chain`` (``csrc/fpu_chain.cu``; the dependent chains of
``repro/arch/calibrate.py``) and ``pe_scoreboard.pe_scoreboard``
(``csrc/pe_scoreboard.cu``; the PE scoreboard scan of
``repro/core/pe.py``).

Kernels are built at first use (:mod:`repro_torch.kernels._build`); a
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors. :mod:`repro_torch.kernels.ops` is the model-facing
layer over them and :mod:`repro_torch.kernels.ref` holds the plain oracles.
"""
