"""whisper-small [audio] - enc-dec, conv frontend STUB [arXiv:2212.04356].

The mel/conv frontend is stubbed: input_specs() provides precomputed frame
embeddings (B, 1500, d_model). Sinusoidal positions on both sides so the
assigned 32k decode horizon lowers cleanly (DESIGN.md section 4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, head_dim=64,
    d_ff=3072, vocab=51865, act="gelu", glu=False,
    encoder_layers=12, encoder_seq=1500, frontend="audio",
    pos="sinusoidal",
)
