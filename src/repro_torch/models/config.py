"""Unified model configuration covering every assigned architecture family.

A verbatim copy of ``repro.models.config`` (pure Python), so the port
reads the same configurations without importing the JAX package. One
frozen dataclass parameterizes dense / MoE / SSM / hybrid / enc-dec / VLM
backbones; each ``repro_torch/configs/<arch>.py`` instantiates it with the
exact published numbers plus a reduced smoke variant. The port builds
every family (``repro_torch.models.model.build_model``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | rwkv6 | zamba2 | encdec | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    d_ff: int
    # Attention (ignored by rwkv6).
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # SWA width (h2o-danube)
    # At long context (>= long_context_threshold cache), archs that support
    # it clamp attention to this window (zamba2's shared block; see
    # DESIGN.md long_500k notes).
    long_context_window: Optional[int] = None
    activation: str = "swiglu"    # swiglu | squared_relu | gelu
    tie_embeddings: bool = False
    # MoE.
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512     # group-wise einsum dispatch (T5X-style)
    # SSM / RWKV / hybrid.
    ssm_state: int = 0            # Mamba2 state size N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    attn_every: int = 0           # zamba2: shared attn block period
    chunk_size: int = 32          # chunked linear-recurrence length
    # Enc-dec.
    encoder_layers: int = 0
    decoder_layers: int = 0
    frontend_dim: int = 0         # stubbed modality frontend output dim
    # VLM.
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w of head_dim/2
    # Quantization (the CUTIE / ternary serving path).
    quant: Optional[str] = None   # None | "ternary"
    # Numerics.
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_kv_heads == 0 and self.num_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # -- derived ----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_sub_quadratic(self) -> bool:
        """Whether long_500k decode is admissible (bounded per-step state)."""
        return (self.family in ("rwkv6", "zamba2")
                or self.sliding_window is not None)

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementations; used by
        MODEL_FLOPS roofline terms)."""
        d, l, v, f = self.d_model, self.num_layers, self.vocab_size, self.d_ff
        if self.family == "rwkv6":
            r = self.rwkv_lora_rank
            tm = d * (5 * r) + 5 * r * d          # ddlerp loras
            tm += d * r + r * d                    # decay lora (w1, w2)
            tm += 4 * d * d + d * d                # r,k,v,g + out
            tm += 2 * d                            # ln scales (2 norms)
            tm += 3 * self.rwkv_heads * self.rwkv_head_dim  # u, w0(bias), gn
            cm = 2 * d * f // 1 if False else d * f + f * d + d * d  # k,v,r
            per_layer = tm + cm + 2 * d
            return v * d + l * per_layer + d + (0 if self.tie_embeddings
                                                else v * d)
        # attention params (dense/moe/vlm/encdec/zamba2-shared)
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.activation == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            ef = self.expert_d_ff or f
            routed = self.num_experts * 3 * d * ef
            shared = self.num_shared_experts * 3 * d * ef
            router = d * self.num_experts
            mlp = routed + shared + router
        per_layer = attn + mlp + 2 * d
        if self.family == "zamba2":
            # mamba2 layer params
            din = self.ssm_d_inner
            n = self.ssm_state
            h = self.ssm_heads
            m_in = d * (2 * din + 2 * n * 1 + h)   # z,x,B,C,dt heads
            conv = (din + 2 * n) * self.conv_kernel
            m_out = din * d
            mamba = m_in + conv + m_out + 3 * h + d
            n_attn = self.num_layers // max(self.attn_every, 1)
            shared_attn = attn + 3 * d * f + 2 * d
            return (v * d + self.num_layers * mamba + shared_attn
                    + d + (0 if self.tie_embeddings else v * d))
        if self.family == "encdec":
            cross = attn
            enc = self.encoder_layers * (attn + mlp + 2 * d)
            dec = self.decoder_layers * (attn + cross + mlp + 3 * d)
            return v * d + enc + dec + 2 * d + (0 if self.tie_embeddings
                                                else v * d)
        total = v * d + l * per_layer + d
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, l = self.d_model, self.num_layers
        ef = self.expert_d_ff or self.d_ff
        hd = self.head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        active_mlp = (self.top_k + self.num_shared_experts) * 3 * d * ef \
            + d * self.num_experts
        per_layer = attn + active_mlp + 2 * d
        total = self.vocab_size * d + l * per_layer + d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total
