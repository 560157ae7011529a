"""Continuous-batching serving engine, single device (the base
configuration of ``megatron_llm_tpu/serving``).

- ``engine.py``: scheduler, admission prefill, batched paged decode,
  per-slot sampling, retirement.
- ``block_pool.py`` / ``slots.py``: paged KV pool and per-slot tables.
- ``queue.py``: bounded admission queue (``QueueFull``).
- ``metrics.py``: counters, gauges and latency reservoirs.
"""

from .engine import (  # noqa: F401
    EngineConfig,
    FinishedRequest,
    RequestHandle,
    ServingEngine,
)
from .metrics import ServingMetrics  # noqa: F401
from .queue import QueueFull, RequestQueue  # noqa: F401
