"""Rank-aware structured JSON event log with request-id correlation
(mirror of ``megatron_llm_tpu/obs/logging.py``).

Every line is one JSON object: ``{"ts", "rank", "component", "event",
"request_id", ...fields}``.  The serving stack emits lines at each
request lifecycle edge (submitted → admitted → first_token → finished,
plus queue_full rejections and HTTP responses) all carrying the same
``request_id``, and the training driver emits one line per log window —
so one ``grep req-17`` (or ``EVENT_LOG.recent(request_id=...)`` in
tests) reconstructs a request's path through queue, engine, and server.

Lines are always retained in a bounded in-memory ring (cheap: a dict
append under a lock) and additionally written to a stream when one is
configured (``configure(stream=sys.stderr)`` or the server CLI's
``--log_json``).  ``rank`` is ``torch.distributed.get_rank()`` when a
process group is initialised, else 0, resolved lazily on first emit;
logs of several processes interleave safely because each line is a
single ``write()`` call.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional

from ..analysis.sanitizers import make_lock

_UNSET = object()


def _resolve_rank() -> int:
    try:
        import torch.distributed as dist  # noqa: PLC0415

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — a log line never fails on its rank
        pass
    return 0


class StructuredLog:
    """Bounded in-memory event ring + optional JSON-lines stream."""

    def __init__(self, stream=None, capacity: int = 4096):
        self._lock = make_lock("obs.eventlog")
        self._stream = stream
        self._events: deque = deque(maxlen=capacity)
        self._rank: Optional[int] = None

    def configure(self, stream=_UNSET, capacity: Optional[int] = None) -> None:
        with self._lock:
            if stream is not _UNSET:
                self._stream = stream
            if capacity is not None:
                self._events = deque(self._events, maxlen=capacity)

    @property
    def rank(self) -> int:
        # lazy: the process group may be initialised after import
        if self._rank is None:
            self._rank = _resolve_rank()
        return self._rank

    def emit(self, component: str, event: str, *,
             request_id: Optional[str] = None, **fields) -> Dict:
        """Record (and maybe write) one event line; returns the dict."""
        line: Dict = {"ts": round(time.time(), 6), "rank": self.rank,
                      "component": component, "event": event}
        if request_id is not None:
            line["request_id"] = request_id
        line.update(fields)
        with self._lock:
            self._events.append(line)
            stream = self._stream
        if stream is not None:
            try:
                stream.write(json.dumps(line, default=str) + "\n")
                stream.flush()
            except Exception:
                pass  # a dead log sink must never take down the scheduler
        return line

    def recent(self, request_id: Optional[str] = None,
               event: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict]:
        """Retained lines, optionally filtered; oldest first."""
        with self._lock:
            lines = list(self._events)
        if request_id is not None:
            lines = [l for l in lines if l.get("request_id") == request_id]
        if event is not None:
            lines = [l for l in lines if l.get("event") == event]
        if limit is not None:
            lines = lines[-limit:]
        return lines

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: Process-global event log every subsystem emits through.
EVENT_LOG = StructuredLog()
