"""Host-side resilience event counters (mirror of ``EventCounters`` and
``RESILIENCE_EVENTS`` in ``megatron_llm_tpu/metrics.py``).

The training driver, the checkpointing layer and the retry helper count
their events here: ``checkpoint_saves``, ``io_retries``, ``io_giveups``,
``checkpoint_fallbacks``, ``checkpoint_gc_deleted``, ``rollbacks``.  Tests
read them with ``get`` or ``snapshot`` (a plain dict).  The eval metrics
registry and the collector hook on an observability registry are not
ported yet (ROADMAP.md, Queue 1 items 6 and 7).
"""

from __future__ import annotations

import threading
from typing import Dict


class EventCounters:
    """Thread-safe named event counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


# the process-global resilience event stream
RESILIENCE_EVENTS = EventCounters()
