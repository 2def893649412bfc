"""Model configurations of the port (``CONFIG``, ``SMOKE``)."""
from repro_torch.configs.colibries import CONFIG, SMOKE, WINDOW_MS

__all__ = ["CONFIG", "SMOKE", "WINDOW_MS"]
