"""qwen3-moe-235b-a22b [moe] - 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=1536, vocab=151936, act="silu", glu=True,
    n_experts=128, top_k=8, d_expert=1536, capacity_factor=1.25,
    rope_theta=1_000_000.0, accum_steps=4,
)
