"""Config reduction shared by the launchers (port of
``repro.launch.train.reduce_config``). The training loop itself waits
(ROADMAP.md A.11)."""
from __future__ import annotations

import dataclasses


def reduce_config(cfg, layers=None, d_model=None, vocab=None, heads=None):
    """Shrink an assigned config to laptop scale, same family/topology."""
    upd = {}
    if layers:
        upd["n_layers"] = layers
        upd["global_layers"] = tuple(
            i for i in cfg.global_layers if i < layers) or (
                (0,) if cfg.family == "hybrid" else ())
        if cfg.family == "encdec":
            upd["encoder_layers"] = max(2, layers // 2)
    if d_model:
        ratio = d_model / cfg.d_model
        upd["d_model"] = d_model
        upd["d_ff"] = max(32, int(cfg.d_ff * ratio)) if cfg.d_ff else 0
        if cfg.family == "moe":
            upd["d_expert"] = max(32, int((cfg.d_expert or cfg.d_ff) * ratio))
            upd["n_experts"] = min(cfg.n_experts, 8)
            upd["top_k"] = min(cfg.top_k, 2)
    if heads:
        upd["n_heads"] = heads
        upd["n_kv"] = max(1, min(cfg.n_kv, heads))
        upd["head_dim"] = (d_model or cfg.d_model) // heads
    if vocab:
        upd["vocab"] = vocab
    return dataclasses.replace(cfg, **upd)
