"""hymba-1.5b [hybrid] - parallel attn+mamba heads [arXiv:2411.13676; hf].

32 layers, d=1600, 25 q heads (GQA kv=5, head_dim 64), sliding-window
attention (1024) on local layers with full attention on {0, 15, 31}, an SSM
path per layer (state 16). Hymba's meta tokens are omitted (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, head_dim=64,
    d_ff=5504, vocab=32001, act="silu", glu=True,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=256, window=1024, global_layers=(0, 15, 31),
)
