"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, head_dim=128,
    d_ff=28672, vocab=32768, act="silu", glu=True,
    rope_theta=1_000_000.0, accum_steps=8,
)
