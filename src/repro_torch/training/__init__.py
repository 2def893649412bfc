"""Training substrate of the port: AdamW (``optimizer``), step-atomic
checkpoints (``checkpoint``, the JAX package's on-disk format),
``deterministic`` (cuDNN's deterministic algorithms for a step, so a
restart from a checkpoint repeats the uninterrupted run's bits) and the
STBP step of the SCNN (``stbp``: ``core.snn.snn_loss``'s gradients, then
AdamW; see ``examples/torch_train_dvs_gesture.py``).

``Trainer``, ``TrainerConfig`` and gradient compression train the LM
families: they come with LM training (ROADMAP queue 1, item 6: the rest
of item 13), as do bfloat16 checkpoints.
"""
from repro_torch.training import checkpoint
from repro_torch.training.checkpoint import (latest_step, list_steps,
                                             restore_checkpoint,
                                             restore_latest,
                                             save_checkpoint)
from repro_torch.training.determinism import deterministic
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update,
                                            clip_by_global_norm,
                                            cosine_schedule, global_norm)
from repro_torch.training.stbp import snn_grads, stbp_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "save_checkpoint",
           "restore_checkpoint", "restore_latest", "latest_step",
           "list_steps", "checkpoint", "deterministic", "snn_grads",
           "stbp_step"]
