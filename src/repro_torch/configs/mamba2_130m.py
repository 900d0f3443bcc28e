"""mamba2-130m [ssm] - SSD, attention-free [arXiv:2405.21060].

d_model=768, expand 2 -> d_inner=1536, 24 SSD heads of dim 64,
state N=128, no FFN (d_ff=0): each layer is one Mamba-2 block.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv=24, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=256, tie_embeddings=True,
)
