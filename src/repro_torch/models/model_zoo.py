"""Unified model API (port of ``repro.models.model_zoo``): init / forward /
prefill / init_caches / decode_step / param_count / active_param_count
over all six families (dense, moe, ssm, hybrid, vlm, encdec).

The entry points run on the device the model lives on, which
:func:`init` puts on ``cuda`` unless the caller asks for the CPU; on the
card the full-sequence paths (forward, prefill) run kernels B5 and B6 in
every layer that has attention or an SSM (the encoder-decoder: B5 in the
encoder, the decoder's self-attention and its cross-attention).

Grad mode: :func:`prefill` and :func:`decode_step` serve and run under
``torch.no_grad()``. :func:`forward` runs in the caller's grad mode, so
the trainer takes gradients through it; a model's parameters are built
without ``requires_grad`` (``train.train_state.init_state`` turns it on),
so a forward over a serving model records nothing. The kernels have no
backward (nor have the reference's): a forward that records on the card
passes ``use_kernels=False`` (the reference's ``use_pallas=False``) and
takes the plain oracles; with the kernels it raises. The ``cfg`` arguments
mirror the reference's signatures; the model carries its own.

``shard_fn(x, name)`` is the reference's activation hook (identity by
default; :func:`repro_torch.distributed.sharding.make_shard_fn` on a
mesh). Nothing here knows of a mesh: a model that
``sharding.shard_model`` put on one runs through :func:`forward` as it
is (its own hooks gather its parameters), and decodes through
``sharding.decode_step``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM, identity_shard

Model = Union[LM, EncDec]


def build(cfg: ModelConfig, device=None) -> Model:
    """The module of ``cfg``'s family on ``device``, its storage
    uninitialized."""
    return (EncDec if cfg.family == "encdec" else LM)(cfg, device=device)


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` with the reference's shapes and
    distributions (truncated normal at +-2 sigma scaled as the reference,
    ones / zeros / log-spaced decays where it has them), drawn from
    ``generator`` (default: a fresh one seeded 0 on ``device``). The values
    differ from the JAX package's for the same seed: see
    :mod:`repro_torch.models.convert` to carry them across."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.models.init builds on 'cuda' by "
                           "default and no CUDA device is available; ask "
                           "for the CPU with device='cpu'")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build(cfg, device)
    for module in model.modules():
        reset = getattr(module, "reset", None)
        if reset is not None:
            reset(generator)
    return model


def forward(model: Model, batch: dict, cfg: ModelConfig,
            use_kernels: Optional[bool] = None, shard_fn=identity_shard):
    """batch: {'tokens': (B, S)} and, for the frontend families,
    {'frames' | 'patches': (B, P, d)}. Returns (logits, aux). Runs in the
    caller's grad mode; ``use_kernels`` as :func:`repro_torch.kernels.ops.
    attention`'s (``None``: the device decides)."""
    if cfg.family == "encdec":
        return model(batch["frames"], batch["tokens"],
                     use_kernels=use_kernels, shard_fn=shard_fn)
    return model(batch["tokens"], batch.get("patches"),
                 use_kernels=use_kernels, shard_fn=shard_fn)


@torch.no_grad()
def prefill(model: Model, batch: dict, cfg: ModelConfig,
            shard_fn=identity_shard, use_kernels: Optional[bool] = None):
    """Returns (logits, aux, caches): the stacked per-layer KV of the
    attention families, None for ssm and hybrid, the encoder's memory for
    the encoder-decoder (as in the reference). ``use_kernels`` as
    :func:`forward`'s (the reference's ``use_pallas``): ``False`` takes
    the plain oracles on any device, as the dry run traces it."""
    if cfg.family == "encdec":
        memory = model.encode(batch["frames"], use_kernels=use_kernels,
                              shard_fn=shard_fn)
        logits = model.decode_train(batch["tokens"], memory,
                                    use_kernels=use_kernels,
                                    shard_fn=shard_fn)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device), memory
    return model.prefill(batch["tokens"], batch.get("patches"),
                         shard_fn=shard_fn, use_kernels=use_kernels)


def init_caches(model: Model, cfg: ModelConfig, batch: int, max_len: int,
                memory: Optional[torch.Tensor] = None,
                dtype=torch.bfloat16):
    if cfg.family == "encdec":
        assert memory is not None, "encdec caches need the encoder memory"
        return model.init_decode_caches(memory, batch, max_len, dtype)
    return model.init_caches(batch, max_len, dtype)


@torch.no_grad()
def decode_step(model: Model, token: torch.Tensor, cfg: ModelConfig, caches,
                cache_index: int, shard_fn=identity_shard):
    """token (B, 1) -> (logits (B, 1, V), caches updated in place)."""
    return model.decode_step(token, caches, cache_index, shard_fn=shard_fn)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from the module built on the meta device (no
    allocation)."""
    return sum(p.numel() for p in build(cfg, "meta").parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: the total less the experts a token
    does not select."""
    total = param_count(cfg)
    if cfg.family != "moe":
        return total
    de = cfg.d_expert or cfg.d_ff
    per_expert = cfg.d_model * de * (3 if cfg.glu else 2)
    return total - cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
