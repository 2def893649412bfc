"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed top-6, expert d_ff=1408. 28L d_model=2048 16H (MHA kv=16)
vocab=102400. (Published dense first layer folded into the uniform MoE
stack; FLOP delta < 0.5% -- DESIGN.md.)"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, vocab_size=102_400, d_ff=1408,
    num_heads=16, num_kv_heads=16, head_dim=128,
    rope_theta=10_000.0, activation="swiglu",
    num_experts=64, top_k=6, num_shared_experts=2, expert_d_ff=1408,
    moe_group_size=256,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    num_layers=2, d_model=64, vocab_size=256, d_ff=64,
    num_heads=4, num_kv_heads=4, head_dim=16,
    num_experts=8, top_k=2, num_shared_experts=2, expert_d_ff=64,
    moe_group_size=8, dtype="float32",
)
