"""Data pipelines of the port: deterministic synthetic LM tokens and
DVS-gesture event batches (``repro.data``'s names)."""
from repro_torch.data.synthetic import (DVSBatch, TokenTaskConfig,
                                        dvs_gesture_batch, token_batch,
                                        token_stream)

__all__ = ["DVSBatch", "TokenTaskConfig", "dvs_gesture_batch",
           "token_batch", "token_stream"]
