"""glm4-9b [hf:THUDM/glm-4-9b]: dense, RoPE, strong GQA (kv=2).
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, vocab_size=151_552, d_ff=13_696,
    num_heads=32, num_kv_heads=2, head_dim=128,
    rope_theta=10_000.0, activation="swiglu",
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256, d_ff=192,
    num_heads=4, num_kv_heads=1, head_dim=16,
    activation="swiglu", dtype="float32",
)
