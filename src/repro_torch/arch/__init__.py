"""repro_torch.arch - machine/FPU architecture specs (port of ``repro.arch``).

Same value types, registry and ambient-machine scoping as the reference;
spec JSON files are interchangeable between the two packages::

    from repro_torch import arch
    m = arch.MachineSpec.load("my_machine.json")   # written by either package
    with arch.machine_scope(m):
        ...

The port adds ``"h100"`` (:data:`H100`), the machine of CUDA tensors: a
call that names no machine is priced for the machine of its device
(:func:`device_machine`). :func:`calibrate` fits a ``calibrated-cuda`` spec
from micro-benchmarks on the card (``backend="cpu"``: ``calibrated-cpu``).
"""
from repro_torch.arch.calibrate import (CALIBRATION_TOLERANCE,
                                        CalibrationResult, calibrate,
                                        calibrate_full, load_or_calibrate)
from repro_torch.arch.registry import (CPU_HOST, DEFAULT_MACHINE, H100,
                                       PAPER_PE, TPU_LIKE, current_machine,
                                       device_machine, get,
                                       machine_key_component, machine_scope,
                                       names, register, resolve_machine,
                                       set_default_machine)
from repro_torch.arch.spec import (OP_CLASSES, FPUSpec, MachineSpec,
                                   MemorySpec, PEGeometry, PowerAreaSpec)

__all__ = [
    # spec types
    "MachineSpec", "FPUSpec", "MemorySpec", "PEGeometry", "PowerAreaSpec",
    "OP_CLASSES",
    # registry
    "get", "register", "names", "DEFAULT_MACHINE",
    # ambient machine scoping
    "current_machine", "machine_scope", "set_default_machine",
    "resolve_machine", "machine_key_component", "device_machine",
    # built-in specs
    "TPU_LIKE", "PAPER_PE", "CPU_HOST", "H100",
    # measured-machine calibration
    "calibrate", "calibrate_full", "load_or_calibrate",
    "CalibrationResult", "CALIBRATION_TOLERANCE",
    # benchmark helper
    "bench_metrics",
]


def bench_metrics(gflops: float, machine=None,
                  hbm_bytes_per_s: float = 0.0) -> dict:
    """The per-row machine fields every benchmark records:
    ``{"machine", "gflops", "gflops_per_w", "gflops_per_mm2"}`` for an
    achieved FLOP rate under ``machine`` (default: the ambient machine) -
    modeled scores, the paper's two comparison axes."""
    m = resolve_machine(machine)
    g = float(gflops)
    return {"machine": m.name, "gflops": g,
            "gflops_per_w": m.gflops_per_w(g, hbm_bytes_per_s),
            "gflops_per_mm2": m.gflops_per_mm2(g)}
