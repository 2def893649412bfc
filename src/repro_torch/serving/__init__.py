"""Serving layer of the port: the streaming engine over one lane per
sensor modality (``stream``), cross-wing fusion sessions and stream
checkpoints (``session``), and LM serving (``serve``: ``generate``,
``quantize_for_serving``; ``scheduler``: ``BatchScheduler``)."""
from repro_torch.serving.scheduler import BatchScheduler, Request
from repro_torch.serving.serve import (ServeConfig, ServeStats, generate,
                                       quantize_for_serving)
from repro_torch.serving.session import (FusionSession, StreamCheckpoint,
                                         late_logit_fusion)
from repro_torch.serving.stream import (DeadLetter, DeadlinePolicy,
                                        EngineConfig, FairQuantumPolicy,
                                        LaneTelemetry, RecoveryConfig,
                                        SlotPolicy, StreamEngine,
                                        StreamHandle, StreamResult,
                                        StreamStats, StreamStatsSnapshot)

__all__ = ["BatchScheduler", "DeadLetter", "DeadlinePolicy", "EngineConfig",
           "FairQuantumPolicy", "FusionSession", "LaneTelemetry",
           "RecoveryConfig", "Request", "ServeConfig", "ServeStats",
           "SlotPolicy", "StreamCheckpoint", "StreamEngine", "StreamHandle",
           "StreamResult", "StreamStats", "StreamStatsSnapshot", "generate",
           "late_logit_fusion", "quantize_for_serving"]
