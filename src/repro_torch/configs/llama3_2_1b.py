"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B]: small llama3, tied embeddings.
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    num_layers=16, d_model=2048, vocab_size=128_256, d_ff=8192,
    num_heads=32, num_kv_heads=8, head_dim=64,
    rope_theta=500_000.0, activation="swiglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256, d_ff=160,
    num_heads=4, num_kv_heads=2, head_dim=16,
    activation="swiglu", tie_embeddings=True, dtype="float32",
)
