"""granite-3-8b [dense] - GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=12800, vocab=49155, act="silu", glu=True,
    rope_theta=10_000.0, tie_embeddings=True, accum_steps=2,
)
