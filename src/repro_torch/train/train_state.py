"""Train state and the step builders (port of ``repro.train.train_state``).

The state is ``{"params": model, "opt": optimizer state}``: the model holds
the f32 master parameters, which the forward casts to ``cfg.dtype``;
gradients come out in f32. A step takes the gradients through
``model_zoo.forward(..., use_kernels=False)`` — the plain oracles, the
reference's ``use_pallas=False`` — in grad mode, with per-layer remat under
``cfg.remat_policy`` (:func:`repro_torch.models.transformer.maybe_remat`),
then runs the AdamW update in place. ``accum_steps`` > 1 loops over the
microbatches and adds their gradients in f32 (the reference scans them).

On a mesh the state is :func:`repro_torch.distributed.sharding.place_state`'s
(DTensors at ``state_specs``' placements) and the batch is
``data.pipeline.make_batch(..., sharding=)``'s: each rank runs its rows,
the blocks gather their parameters, the gradients come back
reduce-scattered to the parameters' placements, and the update runs on
the shards (``sharding``'s docstring); the loss is the mean over the DP
ranks. ``shard_fn`` is the models' hook (``sharding.make_shard_fn``). The
reference's ``donate`` flag has no counterpart: the step always updates
the state in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models import model_zoo
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import identity_shard
from repro_torch.train import optimizer
from repro_torch.train.losses import next_token_loss
from repro_torch.train.optimizer import AdamWConfig


def init_state(generator: Optional[torch.Generator], cfg: ModelConfig,
               opt_cfg: AdamWConfig, device="cuda") -> dict:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU) drawn from ``generator`` (see ``model_zoo.init``), its
    parameters requiring grad, and zero optimizer state."""
    model = model_zoo.init(cfg, generator, device)
    return state_for(model, opt_cfg)


def state_for(model: model_zoo.Model, opt_cfg: AdamWConfig) -> dict:
    """The train state of an existing model (for example one that
    ``convert.from_jax_params`` built): its parameters set to require
    grad, zero optimizer state."""
    model.requires_grad_(True)
    return {"params": model,
            "opt": optimizer.init(optimizer.named_parameters(model),
                                  opt_cfg)}


def _loss(model, micro: dict, cfg: ModelConfig,
          shard_fn=identity_shard) -> torch.Tensor:
    logits, aux = model_zoo.forward(model, micro, cfg, use_kernels=False,
                                    shard_fn=shard_fn)
    return next_token_loss(logits, micro["tokens"]) + aux


def value_and_grad(model, params: Dict[str, torch.nn.Parameter],
                   micro: dict, cfg: ModelConfig, shard_fn=identity_shard):
    """(loss, {path: f32 gradient}) of one (micro)batch, with grads on;
    a parameter the loss does not reach gets zeros, as in JAX. On a mesh
    the loss is this rank's rows' and the gradients the DTensors of the
    mean over the DP ranks."""
    with torch.enable_grad():
        loss = _loss(model, micro, cfg, shard_fn)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(params.items(), grads)}


def _hook(shard_fn, mesh, batch: dict):
    """The models' hook for a step on ``batch``: on a mesh (the identity
    default becomes ``sharding.make_shard_fn(mesh)``) told whether the
    batch's rows are split over the DP ranks, which the moe FFN's global
    dispatch reads."""
    if mesh is None:
        return shard_fn
    if shard_fn is identity_shard:
        shard_fn = sharding.make_shard_fn(mesh)
    return sharding.rows_hook(shard_fn, sharding.rows_split(batch["tokens"],
                                                            mesh))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, sharding.DTensor):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    shard_fn=identity_shard) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics
    {"loss", "grad_norm", "lr"} as f32 scalars on the device.

    ``batch['tokens']``: (accum, B/accum, S) when accum_steps > 1 else
    (B, S) (``data.pipeline.make_batch(..., accum=)`` reshapes); the
    microbatches run in order. A DTensor batch gives each rank its
    rows."""
    accum = max(cfg.accum_steps, 1)

    def train_step(state: dict, batch: dict):
        model = state["params"]
        params = optimizer.named_parameters(model)
        mesh = sharding.model_mesh(model)
        hook = _hook(shard_fn, mesh, batch)
        batch = {k: sharding.local(v) for k, v in batch.items()}
        if accum == 1:
            loss, grads = value_and_grad(model, params, batch, cfg, hook)
        else:
            grads = {k: _zeros_f32(p) for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=sharding.local(next(iter(
                                   params.values()))).device)
            for i in range(accum):
                micro = {k: v[i] for k, v in batch.items()}
                l, g = value_and_grad(model, params, micro, cfg, hook)
                for k in grads:
                    grads[k] += g[k].float()
                loss = loss + l
                del g
            grads = {k: g / accum for k, g in grads.items()}
            loss = loss / accum
        if mesh is not None:
            loss = sharding.mesh_sum(loss, mesh, sharding.batch_axes(
                mesh)) / sharding.dp_size(mesh)
        _, new_opt, stats = optimizer.update(grads, state["opt"], params,
                                             opt_cfg)
        return {"params": model, "opt": new_opt}, {"loss": loss, **stats}

    return train_step


def make_eval_step(cfg: ModelConfig, shard_fn=identity_shard) -> Callable:
    """Returns eval_step(state, batch) -> {"loss"}: the train step's loss,
    without grads, on the same plain route as the reference's (on a
    mesh: this rank's rows' loss)."""

    @torch.no_grad()
    def eval_step(state: dict, batch: dict):
        hook = _hook(shard_fn, sharding.model_mesh(state["params"]), batch)
        batch = {k: sharding.local(v) for k, v in batch.items()}
        return {"loss": _loss(state["params"], batch, cfg, hook)}

    return eval_step
