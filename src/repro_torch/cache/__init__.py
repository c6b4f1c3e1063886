"""Client-side data caching: the tiered RAM + simulated-SSD
extent cache.  See :mod:`repro_torch.cache.extent_cache`."""

from .extent_cache import TieredExtentCache

__all__ = ["TieredExtentCache"]
