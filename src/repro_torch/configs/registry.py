"""Architecture registry and the assigned input-shape sets (port of
``repro.configs.registry``).

Every (arch x shape) cell resolves to (kind, input specs) where kind is
'train' | 'prefill' | 'decode'. A spec is a ``(shape, torch.dtype)`` pair
where the reference has a ``jax.ShapeDtypeStruct``. ``long_500k`` is only
defined for sub-quadratic archs (SSM / windowed hybrid).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_tokens

ARCHS = (
    "minitron-8b", "granite-3-8b", "gemma-7b", "mistral-large-123b",
    "whisper-small", "mamba2-130m", "hymba-1.5b", "internvl2-1b",
    "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4_096, 256),
    ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    ShapeSpec("decode_32k", "decode", 32_768, 128),
    ShapeSpec("long_500k", "decode", 524_288, 1),
)

SHAPE_BY_NAME: Dict[str, ShapeSpec] = {s.name: s for s in SHAPES}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is the (arch, shape) cell defined? Returns (ok, reason_if_not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 512k context is "
                       "infeasible; skipped per assignment for pure "
                       "full-attention archs")
    return True, ""


def input_specs(arch: str, shape_name: str, accum: Optional[int] = None,
                global_batch: Optional[int] = None):
    """(shape, dtype) stand-ins for every model input of a cell.

    Returns (kind, specs dict). For 'train', tokens are (accum, B/accum, S)
    when accumulation is on. For 'decode', the specs cover the incoming
    token and the cache index; caches are built by ``init_caches``.
    ``global_batch`` cuts the shape's batch B (a cell measured on one
    card at a smaller batch).
    """
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"cell ({arch}, {shape_name}) undefined: {why}")
    b, s = global_batch or shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    nf = frontend_tokens(cfg)
    key = "frames" if cfg.frontend == "audio" else "patches"
    if shape.kind == "train":
        a = accum if accum is not None else cfg.accum_steps
        a = max(min(a, b), 1)
        specs = {"tokens": ((a, b // a, s), i32) if a > 1 else ((b, s), i32)}
        if nf:
            specs[key] = (((a, b // a, nf, cfg.d_model) if a > 1
                           else (b, nf, cfg.d_model)), bf16)
        return "train", specs
    if shape.kind == "prefill":
        specs = {"tokens": ((b, s), i32)}
        if nf:
            specs[key] = ((b, nf, cfg.d_model), bf16)
        return "prefill", specs
    return "decode", {"token": ((b, 1), i32), "cache_index": ((), i32)}


def all_cells():
    """Every defined (arch, shape) cell and the skipped ones with reasons."""
    defined, skipped = [], []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = cell_supported(cfg, s)
            (defined if ok else skipped).append((a, s.name) if ok
                                                else (a, s.name, why))
    return defined, skipped
