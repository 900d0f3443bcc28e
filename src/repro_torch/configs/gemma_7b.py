"""gemma-7b [dense] - GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu", glu=True,      # GeGLU
    rope_theta=10_000.0, tie_embeddings=True, logit_softcap=30.0,
    accum_steps=2,
)
