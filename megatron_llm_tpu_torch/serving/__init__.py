"""Continuous-batching serving engine, single device (the base
configuration of ``megatron_llm_tpu/serving``).

- ``engine.py``: scheduler, admission prefill, batched paged decode,
  per-slot sampling, retirement.
- ``block_pool.py`` / ``slots.py``: paged KV pool (ref counts,
  copy-on-write) and per-slot tables.
- ``prefix_cache.py``: the radix trie of cached prompt prefixes.
- ``queue.py``: bounded admission queue (``QueueFull``).
- ``metrics.py``: counters, gauges and latency reservoirs.
- ``adapters/``: the multi-tenant LoRA registry (arena residency, LRU
  with pinning).
- ``cluster/``: sharded engines and replicas behind the router
  (``Router``, ``RouterConfig``, ``RouterHandle``, ``build_cluster``,
  ``build_sharded_engine``).
- ``profile.py`` / ``prefix_profile.py``: where a served request's device
  time goes, and what a prefix hit costs and gives, on a card.
"""

from .cluster import (  # noqa: F401
    Router,
    RouterConfig,
    RouterHandle,
    build_cluster,
    build_disagg_cluster,
    build_sharded_engine,
)
from .engine import (  # noqa: F401
    EngineConfig,
    FinishedRequest,
    RequestHandle,
    ServingEngine,
)
from .metrics import ServingMetrics  # noqa: F401
from .prefix_cache import PrefixCache, PrefixLease  # noqa: F401
from .queue import QueueFull, RequestQueue  # noqa: F401
