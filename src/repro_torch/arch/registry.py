"""Named machine registry + the ambient "current machine" scope.

Port of ``repro.arch.registry``. The built-in machines are field-for-field
the reference's:

``"tpu-like"``
    The default (TPU v5e assumptions, native bfloat16). The port's planners
    still price this machine, so their plans stay bit-equal to the
    reference's; a Hopper-shaped spec is later work.
``"paper-pe"``
    The paper's PE/APE-based accelerator (section-5 pipeline depths,
    double-precision native).
``"cpu-host"``
    A host-CPU-shaped machine.

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

_REGISTRY: Dict[str, MachineSpec] = {
    m.name: m for m in (TPU_LIKE, PAPER_PE, CPU_HOST)
}


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


def current_machine() -> MachineSpec:
    """The active machine: innermost :func:`machine_scope`, else the
    :func:`set_default_machine` process default, else ``"tpu-like"``."""
    scoped = _scope.get()
    if scoped is not None:
        return scoped
    if _process_default is not None:
        return _process_default
    return _REGISTRY[DEFAULT_MACHINE]


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
    """Replace the process-default machine (``None`` resets to
    ``"tpu-like"``); scopes layer on top."""
    global _process_default
    _process_default = _as_spec(machine)
    return current_machine()


def resolve_machine(machine: Union[MachineSpec, str, None] = None) -> MachineSpec:
    """A ``machine=`` argument as a MachineSpec (``None`` = the ambient
    :func:`current_machine`)."""
    if machine is None:
        return current_machine()
    spec = _as_spec(machine)
    return spec if spec is not None else current_machine()


def machine_key_component(machine: Union[MachineSpec, str, None]) -> Optional[str]:
    """The tune-registry key component for a machine: ``None`` for the
    default machine, the machine name otherwise (same rule as the
    reference, so registry files are shared)."""
    mach = resolve_machine(machine)
    return None if mach.name == DEFAULT_MACHINE else mach.name
