"""Serving layer of the port: the streaming engine over one lane per
sensor modality (``stream``), cross-wing fusion sessions (``session``),
and LM serving (``serve``: ``generate``, ``quantize_for_serving``;
``scheduler``: ``BatchScheduler``)."""
from repro_torch.serving.scheduler import BatchScheduler, Request
from repro_torch.serving.serve import (ServeConfig, ServeStats, generate,
                                       quantize_for_serving)
from repro_torch.serving.session import FusionSession, late_logit_fusion
from repro_torch.serving.stream import (EngineConfig, FairQuantumPolicy,
                                        SlotPolicy, StreamEngine,
                                        StreamHandle, StreamResult,
                                        StreamStats)

__all__ = ["BatchScheduler", "EngineConfig", "FairQuantumPolicy",
           "FusionSession", "Request", "ServeConfig", "ServeStats",
           "SlotPolicy", "StreamEngine", "StreamHandle", "StreamResult",
           "StreamStats", "generate", "late_logit_fusion",
           "quantize_for_serving"]
