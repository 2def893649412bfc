"""nemotron-4-340b [arXiv:2402.16819]: dense, GQA, squared-ReLU MLP.
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18_432, vocab_size=256_000, d_ff=73_728,
    num_heads=96, num_kv_heads=8, head_dim=192,
    rope_theta=10_000.0, activation="squared_relu",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    num_layers=2, d_model=96, vocab_size=256, d_ff=384,
    num_heads=4, num_kv_heads=2, head_dim=24,
    activation="squared_relu", dtype="float32",
)
