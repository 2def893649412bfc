"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: MoE 16
routed experts top-1 + 1 shared (Llama-4 style). 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048. Text backbone (early fusion out of
scope per assignment). 40 heads % 16 mesh != 0 -> sharding falls back to
head_dim (see distributed/sharding.py)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, vocab_size=202_048, d_ff=8192,
    num_heads=40, num_kv_heads=8, head_dim=128,
    rope_theta=500_000.0, activation="swiglu",
    num_experts=16, top_k=1, num_shared_experts=1, expert_d_ff=8192,
    moe_group_size=256,
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    num_layers=2, d_model=64, vocab_size=256, d_ff=128,
    num_heads=4, num_kv_heads=2, head_dim=16,
    num_experts=4, top_k=1, num_shared_experts=1, expert_d_ff=128,
    moe_group_size=8, dtype="float32",
)
