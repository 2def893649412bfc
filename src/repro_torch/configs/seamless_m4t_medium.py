"""seamless-m4t-medium [arXiv:2308.11596]: enc-dec multimodal backbone.
12L (x2: encoder+decoder) d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206. Audio frontend stubbed: input_specs provides precomputed
1024-d frame embeddings. vocab 256206 % 16 != 0 -> vocab dim left
unsharded by the divisibility fallback (DESIGN.md)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, d_model=1024, vocab_size=256_206, d_ff=4096,
    num_heads=16, num_kv_heads=16, head_dim=64,
    encoder_layers=12, decoder_layers=12, frontend_dim=1024,
    activation="gelu",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, d_model=64, vocab_size=254, d_ff=128,
    num_heads=4, num_kv_heads=4, head_dim=16,
    encoder_layers=2, decoder_layers=2, frontend_dim=32,
    activation="gelu", dtype="float32",
)
