"""Named machine registry + the ambient "current machine" scope.

Port of ``repro.arch.registry``. The built-in machines are field-for-field
the reference's:

``"tpu-like"``
    The default (TPU v5e assumptions, native bfloat16), and the machine of
    CPU tensors: the port's plans for them stay bit-equal to the
    reference's.
``"paper-pe"``
    The paper's PE/APE-based accelerator (section-5 pipeline depths,
    double-precision native).
``"cpu-host"``
    A host-CPU-shaped machine.
``"h100"``
    One NVIDIA H100 SXM (Hopper, sm_90), the machine of CUDA tensors. The
    port's own; the reference has no GPU spec.

Which machine prices a call: the innermost :func:`machine_scope` (which
``linalg.use(machine=...)`` enters), else the :func:`set_default_machine`
process default, else the machine of the device the call runs on
(:func:`device_machine`: ``"h100"`` for ``cuda``, :data:`DEFAULT_MACHINE`
for ``cpu`` and for a call that names no device). A named machine always
wins. The tune-registry key rule stays the reference's, per device: the
device's own machine adds no key component, any other machine its name
(:func:`machine_key_component`).

The current machine is dynamically scoped (contextvars): :func:`machine_scope`
nests, :func:`set_default_machine` replaces the process default.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Tuple, Union

from repro_torch.arch.spec import (FPUSpec, MachineSpec, MemorySpec,
                                   PEGeometry, PowerAreaSpec)

DEFAULT_MACHINE = "tpu-like"

TPU_LIKE = MachineSpec(
    name="tpu-like",
    native_dtype="bfloat16",
    fpu=FPUSpec(
        depths={"mul": 5, "add": 6, "div": 12, "sqrt": 14},
        t_p={"mul": 60.0, "add": 40.0, "div": 160.0, "sqrt": 200.0},
        t_o=1.0,
        gamma={"mul": 0.5, "add": 0.5, "div": 0.8, "sqrt": 0.9},
        acc_overhead=0.75,
    ),
    memory=MemorySpec(hbm_bw=819e9, vmem_bytes=96 * 2 ** 20, ici_bw=50e9,
                      hbm_bytes=16 * 2 ** 30, pipeline_fill_s=2e-6),
    pe=PEGeometry(mxu=128, sublane=8, lane=128, vreg_budget=64,
                  peak_flops=197e12),
    power_area=PowerAreaSpec(
        pj_per_flop={"mul": 0.55, "add": 0.25, "div": 4.0, "sqrt": 5.0},
        pj_per_byte_hbm=30.0, static_w=60.0, area_mm2=300.0),
)

PAPER_PE = MachineSpec(
    name="paper-pe",
    native_dtype="float64",
    fpu=FPUSpec(
        depths={"mul": 5, "add": 4, "div": 12, "sqrt": 14},
        t_p={"mul": 60.0, "add": 40.0, "div": 160.0, "sqrt": 200.0},
        t_o=1.0,
        gamma={"mul": 0.5, "add": 0.5, "div": 0.8, "sqrt": 0.9},
        acc_overhead=0.75,
    ),
    memory=MemorySpec(hbm_bw=256e9, vmem_bytes=4 * 2 ** 20, ici_bw=25e9,
                      hbm_bytes=8 * 2 ** 30, pipeline_fill_s=1e-6),
    pe=PEGeometry(mxu=32, sublane=4, lane=32, vreg_budget=32,
                  peak_flops=8e12),
    power_area=PowerAreaSpec(
        pj_per_flop={"mul": 0.5, "add": 0.3, "div": 3.0, "sqrt": 3.5},
        pj_per_byte_hbm=25.0, static_w=1.1, area_mm2=6.1),
)

CPU_HOST = MachineSpec(
    name="cpu-host",
    native_dtype="float32",
    fpu=FPUSpec(
        depths={"mul": 4, "add": 4, "div": 14, "sqrt": 18},
        t_p={"mul": 60.0, "add": 40.0, "div": 160.0, "sqrt": 200.0},
        t_o=1.0,
        gamma={"mul": 0.5, "add": 0.5, "div": 0.8, "sqrt": 0.9},
        acc_overhead=0.5,
    ),
    memory=MemorySpec(hbm_bw=80e9, vmem_bytes=2 * 2 ** 20, ici_bw=10e9,
                      hbm_bytes=64 * 2 ** 30, pipeline_fill_s=5e-6),
    pe=PEGeometry(mxu=16, sublane=1, lane=16, vreg_budget=32,
                  peak_flops=2e12),
    power_area=PowerAreaSpec(
        pj_per_flop={"mul": 8.0, "add": 6.0, "div": 30.0, "sqrt": 40.0},
        pj_per_byte_hbm=60.0, static_w=30.0, area_mm2=200.0),
)

# One H100 SXM. Sources: NVIDIA's H100 data sheet and the Hopper
# architecture white paper (the figures chip_smoke.py prices its bounds
# with), the FPU depths from this package's own chain probe on the card
# (csrc/fpu_chain.cu through arch.calibrate, chip_smoke.py's tune phase; the
# run is named in PERF.md). Values marked "assumption" have no published
# source and are modeling constants of this spec.
H100 = MachineSpec(
    name="h100",
    # the paper's workload is f32/f64 dense LAPACK, which the FP32 (FFMA)
    # and FP64 (tensor-core) rates price alike; one peak_flops cannot hold
    # the 989 TFLOP/s bf16 tensor rate as well (ROADMAP.md section C)
    native_dtype="float32",
    fpu=FPUSpec(
        # dependent-issue latency in SM cycles of each class: the chain
        # probe's 4.44 / 4.44 / 59.75 / 61.50 cycles per op over 65536
        # steps (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6); div
        # and sqrt are IEEE multi-instruction sequences on Hopper
        depths={"mul": 4, "add": 4, "div": 60, "sqrt": 62},
        # assumption: the paper's characterization constants (as paper-pe)
        t_p={"mul": 60.0, "add": 40.0, "div": 160.0, "sqrt": 200.0},
        t_o=1.0,
        gamma={"mul": 0.5, "add": 0.5, "div": 0.8, "sqrt": 0.9},  # assumption
        acc_overhead=0.75,                                        # assumption
    ),
    memory=MemorySpec(
        hbm_bw=3.35e12,                 # HBM3, data sheet
        vmem_bytes=232448,              # shared memory one CTA may use (227 KB)
        ici_bw=450e9,                   # NVLink 900 GB/s, 450 each way
        hbm_bytes=80 * 10 ** 9,         # 80 GB, data sheet
        pipeline_fill_s=5e-6),          # assumption: one eager launch
    pe=PEGeometry(
        mxu=16,                         # MMA granule: wgmma k16, mma.sync m16
        sublane=4,                      # warp schedulers per SM
        lane=32,                        # warp width
        vreg_budget=255,                # registers per thread
        peak_flops=67e12,               # FP32 (FFMA) and FP64 (tensor), data sheet
        sm_count=132,                   # data sheet
        # the SM clock the FP32 peak implies: 67e12 / (132 SMs x 128 lanes x 2)
        clock_hz=67e12 / (132 * 128 * 2)),
    power_area=PowerAreaSpec(
        # assumption: 100 W static, the rest of the 700 W board limit
        # spread over the FP32 peak (600 W / 67 TFLOP/s ~ 9 pJ per flop);
        # div and sqrt priced as the instruction sequences they run
        pj_per_flop={"mul": 9.0, "add": 9.0, "div": 90.0, "sqrt": 90.0},
        pj_per_byte_hbm=30.0,           # assumption: HBM3 ~ 3.7 pJ/bit
        static_w=100.0,                 # assumption
        area_mm2=814.0),                # GH100 die, white paper
)

_REGISTRY: Dict[str, MachineSpec] = {
    m.name: m for m in (TPU_LIKE, PAPER_PE, CPU_HOST, H100)
}

# the machine of each device type a call can run on (others: DEFAULT_MACHINE)
DEVICE_MACHINES = {"cuda": "h100"}


def register(spec: MachineSpec, overwrite: bool = False) -> MachineSpec:
    """Add a machine to the named registry (``overwrite=True`` to replace)."""
    if not isinstance(spec, MachineSpec):
        raise TypeError(f"register() takes a MachineSpec, "
                        f"got {type(spec).__name__}")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"machine {spec.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> MachineSpec:
    """Look up a registered machine by name; ``ValueError`` on an unknown
    one."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown machine {name!r}; registered machines: "
                         f"{names()}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


_process_default: Optional[MachineSpec] = None
_scope: "contextvars.ContextVar[Optional[MachineSpec]]" = \
    contextvars.ContextVar("repro_torch_arch_machine", default=None)


def _as_spec(machine: Union[MachineSpec, str, None]) -> Optional[MachineSpec]:
    if machine is None or isinstance(machine, MachineSpec):
        return machine
    if isinstance(machine, str):
        return get(machine)
    raise TypeError(f"machine must be a MachineSpec, a registered name, or "
                    f"None; got {type(machine).__name__}")


def _device_type(device) -> Optional[str]:
    if device is None:
        return None
    return getattr(device, "type", None) or str(device).split(":")[0]


def device_machine(device=None) -> MachineSpec:
    """The machine of a device (a ``torch.device``, or a type such as
    ``"cuda"`` / ``"cpu"``): ``"h100"`` for CUDA, :data:`DEFAULT_MACHINE`
    for anything else and for ``None``."""
    return get(DEVICE_MACHINES.get(_device_type(device), DEFAULT_MACHINE))


def current_machine(device=None) -> MachineSpec:
    """The active machine: innermost :func:`machine_scope`, else the
    :func:`set_default_machine` process default, else the machine of
    ``device`` (:func:`device_machine`; ``"tpu-like"`` for ``None``)."""
    scoped = _scope.get()
    if scoped is not None:
        return scoped
    if _process_default is not None:
        return _process_default
    return device_machine(device)


@contextlib.contextmanager
def machine_scope(machine: Union[MachineSpec, str, None]) -> Iterator[MachineSpec]:
    """Scope the current machine; ``None`` pins the scope back to the
    process default."""
    token = _scope.set(_as_spec(machine))
    try:
        yield current_machine()
    finally:
        _scope.reset(token)


def set_default_machine(machine: Union[MachineSpec, str, None]) -> MachineSpec:
    """Replace the process-default machine (``None`` resets it: each call
    is priced for its device's machine again); scopes layer on top."""
    global _process_default
    _process_default = _as_spec(machine)
    return current_machine()


def resolve_machine(machine: Union[MachineSpec, str, None] = None,
                    device=None) -> MachineSpec:
    """A ``machine=`` argument as a MachineSpec (``None`` = the ambient
    :func:`current_machine` of ``device``)."""
    if machine is None:
        return current_machine(device)
    return _as_spec(machine)


def machine_key_component(machine: Union[MachineSpec, str, None],
                          device=None) -> Optional[str]:
    """The tune-registry key component for a machine on a device: ``None``
    for the device's own machine (:func:`device_machine`), the machine name
    otherwise. For ``device=None`` that is the reference's rule (``None``
    for ``"tpu-like"``), so registry files written on the CPU are shared."""
    mach = resolve_machine(machine, device)
    return None if mach.name == device_machine(device).name else mach.name
