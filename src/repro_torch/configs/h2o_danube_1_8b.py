"""h2o-danube-1.8b [arXiv:2401.16818; hf]: llama+mistral mix with
sliding-window attention. 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000. SWA makes long_500k admissible (bounded ring-buffer KV)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, vocab_size=32_000, d_ff=6912,
    num_heads=32, num_kv_heads=8, head_dim=80,
    sliding_window=4096, rope_theta=10_000.0, activation="swiglu",
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256, d_ff=160,
    num_heads=4, num_kv_heads=2, head_dim=16,
    sliding_window=8, activation="swiglu", dtype="float32",
)
