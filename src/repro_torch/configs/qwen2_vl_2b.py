"""qwen2-vl-2b [arXiv:2409.12191]: VLM backbone with M-RoPE (t/h/w rotary
sections) and dynamic resolution. 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936. Vision tower stubbed: input_specs provides patch
embeddings merged at the sequence head. 12 heads % 16 != 0 -> head_dim
sharding fallback."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, vocab_size=151_936, d_ff=8960,
    num_heads=12, num_kv_heads=2, head_dim=128,
    rope_theta=1_000_000.0, activation="swiglu", tie_embeddings=True,
    mrope_sections=(16, 24, 24),
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=2, d_model=64, vocab_size=256, d_ff=160,
    num_heads=4, num_kv_heads=2, head_dim=16,
    mrope_sections=(4, 2, 2), tie_embeddings=True, dtype="float32",
)
