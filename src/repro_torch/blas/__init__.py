"""repro_torch.blas - BLAS level-2/3 cores (port of ``repro.blas``).

Level 1, the d-prefixed deprecation shims and the distributed layer are
later work.
"""
