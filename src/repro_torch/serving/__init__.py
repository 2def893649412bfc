"""Serving layer of the port: the streaming engine over one lane per
sensor modality (``stream``) and cross-wing fusion sessions
(``session``)."""
from repro_torch.serving.session import FusionSession, late_logit_fusion
from repro_torch.serving.stream import (EngineConfig, FairQuantumPolicy,
                                        SlotPolicy, StreamEngine,
                                        StreamHandle, StreamResult,
                                        StreamStats)

__all__ = ["EngineConfig", "FairQuantumPolicy", "FusionSession",
           "SlotPolicy", "StreamEngine", "StreamHandle", "StreamResult",
           "StreamStats", "late_logit_fusion"]
