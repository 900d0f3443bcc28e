"""minitron-8b [dense] - pruned Nemotron [arXiv:2407.14679; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=16384, vocab=256000, act="silu", glu=True,
    rope_theta=500_000.0, accum_steps=2,
)
