"""Serving: the slot-pool engine, the paged engine over it and the HTTP daemon.

Counterpart of crabml_tpu/serving (engine.py, paged.py, http.py).
"""

from .engine import LatencyHistogram, Request, ServingEngine
from .paged import PagedKVCache, PagedServingEngine

__all__ = ["LatencyHistogram", "PagedKVCache", "PagedServingEngine", "Request", "ServingEngine"]
