"""rwkv6-7b "Finch" [arXiv:2404.05892]: attention-free, token-shift,
data-dependent decay. 32L d_model=4096 d_ff=14336 vocab=65536.
O(1) recurrent state. The same numbers as ``repro.configs.rwkv6_7b``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv6",
    num_layers=32, d_model=4096, vocab_size=65_536, d_ff=14_336,
    rwkv_head_dim=64, rwkv_lora_rank=64, chunk_size=16,
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="rwkv6",
    num_layers=2, d_model=64, vocab_size=256, d_ff=160,
    rwkv_head_dim=16, rwkv_lora_rank=8, chunk_size=8, dtype="float32",
)
