"""Serving layer of the port: the streaming engine over event windows."""
from repro_torch.serving.stream import (EngineConfig, FairQuantumPolicy,
                                        SlotPolicy, StreamEngine,
                                        StreamHandle, StreamResult,
                                        StreamStats)

__all__ = ["EngineConfig", "FairQuantumPolicy", "SlotPolicy", "StreamEngine",
           "StreamHandle", "StreamResult", "StreamStats"]
