"""repro_torch.arch - machine/FPU architecture specs (port of ``repro.arch``).

Same value types, registry and ambient-machine scoping as the reference;
spec JSON files are interchangeable between the two packages::

    from repro_torch import arch
    m = arch.MachineSpec.load("my_machine.json")   # written by either package
    with arch.machine_scope(m):
        ...

Measured-machine calibration (``repro.arch.calibrate``) is later work.
"""
from repro_torch.arch.registry import (CPU_HOST, DEFAULT_MACHINE, PAPER_PE,
                                       TPU_LIKE, current_machine, get,
                                       machine_key_component, machine_scope,
                                       names, register, resolve_machine,
                                       set_default_machine)
from repro_torch.arch.spec import (OP_CLASSES, FPUSpec, MachineSpec,
                                   MemorySpec, PEGeometry, PowerAreaSpec)

__all__ = [
    "MachineSpec", "FPUSpec", "MemorySpec", "PEGeometry", "PowerAreaSpec",
    "OP_CLASSES",
    "get", "register", "names", "DEFAULT_MACHINE",
    "current_machine", "machine_scope", "set_default_machine",
    "resolve_machine", "machine_key_component",
    "TPU_LIKE", "PAPER_PE", "CPU_HOST",
]
