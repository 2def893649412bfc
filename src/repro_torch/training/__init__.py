"""Training substrate of the port: AdamW (``optimizer``), step-atomic
checkpoints (``checkpoint``, the JAX package's on-disk format, bfloat16
leaves included), ``deterministic`` (deterministic algorithms for a step,
so a restart from a checkpoint repeats the uninterrupted run's bits), the
STBP step of the SCNN (``stbp``: ``core.snn.snn_loss``'s gradients, then
AdamW; see ``examples/torch_train_dvs_gesture.py``), and LM training:
the fault-tolerant ``Trainer`` (``trainer``) with optional top-k gradient
compression (``compression``).
"""
from repro_torch.training import checkpoint
from repro_torch.training.checkpoint import (latest_step, list_steps,
                                             restore_checkpoint,
                                             restore_latest,
                                             save_checkpoint)
from repro_torch.training.compression import compress_grads, compression_init
from repro_torch.training.determinism import deterministic
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update,
                                            clip_by_global_norm,
                                            cosine_schedule, global_norm)
from repro_torch.training.stbp import snn_grads, stbp_step
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "save_checkpoint",
           "restore_checkpoint", "restore_latest", "latest_step",
           "list_steps", "checkpoint", "deterministic", "snn_grads",
           "stbp_step", "Trainer", "TrainerConfig", "compress_grads",
           "compression_init"]
