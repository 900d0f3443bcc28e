"""internvl2-1b [vlm] - InternViT + qwen2-0.5b backbone [arXiv:2404.16821].

The ViT is a STUB: input_specs() provides 256 precomputed patch embeddings
prepended to the token stream (causal over the full sequence - a recorded
simplification of InternVL's bidirectional image tokens).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, head_dim=64,
    d_ff=4864, vocab=151655, act="silu", glu=True, qkv_bias=True,
    rope_theta=1_000_000.0, frontend="vision", num_prefix_tokens=256,
    tie_embeddings=True,
)
