"""kimi-k2-1t-a32b [moe] - trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; paper-table]. GQA kv=8 per the assigned spec.

1T total / ~32B active params: trained with 8-bit AdamW moments and bf16
params (no fp32 master - stochastic-rounding assumption recorded in
DESIGN.md); fp32 masters alone would need 4 TB.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, head_dim=128,
    d_ff=2048, vocab=163840, act="silu", glu=True,
    n_experts=384, top_k=8, d_expert=2048, capacity_factor=1.25,
    rope_theta=50_000.0, accum_steps=8, opt_8bit=True, master_fp32=False,
)
