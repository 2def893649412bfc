"""zamba2-1.2b [arXiv:2411.15242]: Mamba2 backbone + weight-shared
attention block every 6 layers. 38L d_model=2048 32H (kv=32) d_ff=8192
ssm_state=64. Hybrid => long_500k admissible (SSM state + windowed shared
attention, window 4096 at long context -- DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="zamba2",
    num_layers=38, d_model=2048, vocab_size=32_000, d_ff=8192,
    num_heads=32, num_kv_heads=32, head_dim=64,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    attn_every=6, long_context_window=4096, chunk_size=32,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="zamba2",
    num_layers=4, d_model=64, vocab_size=256, d_ff=128,
    num_heads=4, num_kv_heads=4, head_dim=16,
    ssm_state=8, ssm_head_dim=16, attn_every=2,
    long_context_window=16, chunk_size=8, dtype="float32",
)
