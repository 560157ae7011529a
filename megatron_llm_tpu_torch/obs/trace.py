"""Per-request span tracing with Chrome trace-event export (mirror of
``megatron_llm_tpu/obs/trace.py``).

A ``TraceRecorder`` is a lock-guarded bounded ring of completed spans.
The serving engine records one span per request phase (queued,
prefix_match, prefill, decode, the resident draft's draft_prefill /
draft_absorb / draft_expand) and one per scheduler iteration
(engine_step, with batch size and route as args), plus a ``retire``
instant.  ``chrome_trace`` exports Chrome trace-event JSON
(``chrome://tracing``, Perfetto): complete events (``ph="X"``) with
microsecond timestamps from the recorder's creation, ``tid`` the request
id so each request gets its own track, ``args.request_id`` for
correlation, the JAX package's schema event for event.

``device_annotation`` names the same phases on the card's timeline: an
NVTX range (``torch.cuda.nvtx.range``) when the engine runs on a CUDA
device, a null context on the CPU.  It only annotates; it never changes
what runs.

When ``enabled`` is False every record path returns before taking the
lock; spans are stored as tuples and turned into dicts only at export.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import torch

from ..analysis.sanitizers import make_lock


def device_annotation(name: str, device=None):
    """An NVTX range named ``name`` on a CUDA ``device``, else a no-op
    context manager."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


class TraceRecorder:
    """Bounded ring buffer of completed spans; Chrome-trace JSON export."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._lock = make_lock("obs.trace")
        # (name, ph, t0, dur, tid, request_id, args); the ring drops the
        # oldest spans once it is full
        self._events: deque = deque(maxlen=capacity)
        self._dropped = 0
        self._epoch = time.perf_counter()
        self._pid = os.getpid()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def add(self, name: str, t0: float, t1: float, *,
            request_id: Optional[str] = None, tid: int = 0,
            args: Optional[Dict] = None) -> None:
        """Record a completed span; ``t0``/``t1`` are perf_counter times."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append((name, "X", t0, max(0.0, t1 - t0), tid,
                                 request_id, args))

    def instant(self, name: str, *, request_id: Optional[str] = None,
                tid: int = 0, args: Optional[Dict] = None) -> None:
        """Record a zero-duration marker event (``ph="i"``)."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append((name, "i", time.perf_counter(), 0.0, tid,
                                 request_id, args))

    @contextlib.contextmanager
    def span(self, name: str, *, request_id: Optional[str] = None,
             tid: int = 0, annotate: bool = False, device=None,
             args: Optional[Dict] = None) -> Iterator[None]:
        """Time a block; with ``annotate`` also name it on ``device``'s
        timeline (``device_annotation``)."""
        ctx = (device_annotation(name, device) if annotate
               else contextlib.nullcontext())
        if not self.enabled:
            with ctx:
                yield
            return
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.add(name, t0, time.perf_counter(),
                     request_id=request_id, tid=tid, args=args)

    def chrome_trace(self) -> Dict:
        """The retained spans as a Chrome trace-event JSON object."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        out: List[Dict] = []
        for name, ph, t0, dur, tid, request_id, args in events:
            ev: Dict = {
                "name": name,
                "ph": ph,
                "ts": round((t0 - self._epoch) * 1e6, 3),
                "pid": self._pid,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"  # instant scope: thread
            ev_args = dict(args) if args else {}
            if request_id is not None:
                ev_args["request_id"] = request_id
            if ev_args:
                ev["args"] = ev_args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": dropped}}
