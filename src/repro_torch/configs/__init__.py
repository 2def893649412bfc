"""Model configurations of the port (``CONFIG``, ``SMOKE``, ``TCN_CONFIG``,
``TCN_SMOKE``)."""
from repro_torch.configs.colibries import (CONFIG, SMOKE, TCN_CONFIG,
                                           TCN_SMOKE, WINDOW_MS)

__all__ = ["CONFIG", "SMOKE", "TCN_CONFIG", "TCN_SMOKE", "WINDOW_MS"]
