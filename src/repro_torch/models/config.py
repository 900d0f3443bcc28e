"""Model configuration (port of ``repro.models.config``): the same frozen
dataclass, field for field, with its properties and ``param_count``.

Families: dense (GQA transformer), moe (dense + expert FFNs), ssm (Mamba-2),
hybrid (parallel attn+SSM heads, Hymba-style), encdec (Whisper-style),
vlm/audio (LM backbone + stub modality frontend feeding precomputed
embeddings). The port's model code runs all six.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "silu"                # silu | gelu
    glu: bool = True                 # gated FFN (SwiGLU / GeGLU)
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # expert hidden dim (d_ff if 0)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_every: int = 1               # every k-th layer is MoE
    moe_grouped: bool = False        # per-batch-row (EP-local) dispatch

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_heads: int = 0               # 0 -> d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (Hymba)
    window: Optional[int] = None          # sliding window for local layers
    global_layers: Tuple[int, ...] = ()   # full-attention layer indices

    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                  # precomputed frame count (1500)

    # modality frontend stub (vlm/audio)
    frontend: Optional[str] = None        # 'vision' | 'audio'
    num_prefix_tokens: int = 0            # patch embeddings prepended

    # positions / norm
    rope_theta: float = 10_000.0
    pos: str = "rope"                     # rope | sinusoidal
    norm_eps: float = 1e-6
    logit_softcap: Optional[float] = None

    # numerics / compilation
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | dots | none (hillclimb lever)
    scan_layers: bool = True

    # distribution/runtime defaults (overridable per run)
    accum_steps: int = 1                  # gradient accumulation microbatches
    opt_8bit: bool = False                # 8-bit AdamW moments
    master_fp32: bool = True              # fp32 master params

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? SSM and windowed-hybrid: yes."""
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.window is not None)

    def param_count(self) -> int:
        """Analytical parameter count (for 6ND roofline math)."""
        d, v = self.d_model, self.vocab
        n = v * d                                           # embedding
        if not self.tie_embeddings:
            n += d * v                                      # lm head
        for i in range(self.n_layers):
            n += self._layer_params(i)
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                n += self._attn_params() + self._ffn_params() + 2 * d
            n += self.n_layers * (self._attn_params() + d)  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        de = self.d_expert or self.d_ff
        per_expert = d * de * (3 if self.glu else 2)
        total = self.param_count()
        moe_layers = len([i for i in range(self.n_layers)
                          if i % self.moe_every == 0])
        return (total - moe_layers * self.n_experts * per_expert
                + moe_layers * self.top_k * per_expert)

    def _attn_params(self) -> int:
        d, hq, hkv, hd = self.d_model, self.n_heads, self.n_kv, self.hd
        return d * hq * hd + 2 * d * hkv * hd + hq * hd * d

    def _ffn_params(self) -> int:
        f = self.d_ff
        return self.d_model * f * (3 if self.glu else 2)

    def _moe_params(self) -> int:
        de = self.d_expert or self.d_ff
        per = self.d_model * de * (3 if self.glu else 2)
        return self.n_experts * per + self.d_model * self.n_experts

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, nst, h = self.ssm_groups, self.ssm_state, self.n_ssm_heads
        in_proj = d * (2 * di + 2 * g * nst + h)
        conv = (di + 2 * g * nst) * self.ssm_conv
        return in_proj + conv + 2 * h + di + di * d       # A, dt_bias, norm, out

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        n = 2 * d                                          # two rmsnorms
        if self.family == "ssm":
            return n + self._ssm_params() + self._ffn_params() \
                if self.d_ff else n + self._ssm_params()
        if self.family == "hybrid":
            return n + self._attn_params() + self._ssm_params() // 2 \
                + self._ffn_params()
        n += self._attn_params()
        if self.family == "moe" and i % self.moe_every == 0:
            n += self._moe_params()
        else:
            n += self._ffn_params()
        return n
