"""Bounded admission queue for the continuous-batching engine (mirror of
``megatron_llm_tpu/serving/queue.py``).

Requests wait here until the scheduler has a free KV slot; when the queue
is full ``put_many`` raises ``QueueFull`` with a ``retry_after_s`` hint
(the REST layer's 503 + Retry-After).  Multi-prompt requests are admitted
all-or-nothing.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from ..analysis.sanitizers import make_condition
from ..obs.logging import EVENT_LOG


class QueueFull(Exception):
    """The bounded request queue cannot take the submission right now."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestQueue:
    """Thread-safe bounded queue: HTTP threads produce, the scheduler
    consumes.  Highest ``priority`` pops first, FIFO within a class."""

    def __init__(self, max_size: int = 32, retry_after_s: float = 1.0):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self.retry_after_s = retry_after_s
        self._q: deque = deque()
        self._cond = make_condition("serving.queue")

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def put_many(self, reqs) -> None:
        """Admit all of ``reqs`` or raise ``QueueFull`` (all-or-nothing)."""
        reqs = list(reqs)
        if len(reqs) > self.max_size:
            EVENT_LOG.emit("queue", "queue_full", batch=len(reqs),
                           depth=len(self), capacity=self.max_size)
            raise QueueFull(
                f"request batch of {len(reqs)} exceeds the queue capacity "
                f"({self.max_size})", self.retry_after_s)
        with self._cond:
            if len(self._q) + len(reqs) > self.max_size:
                depth = len(self._q)
                EVENT_LOG.emit("queue", "queue_full", batch=len(reqs),
                               depth=depth, capacity=self.max_size)
                raise QueueFull(
                    f"request queue full ({depth}/{self.max_size})",
                    self.retry_after_s)
            self._q.extend(reqs)
            self._cond.notify_all()

    def pop(self) -> Optional[object]:
        """Next pending request (highest priority, FIFO within a class), or
        None when the queue is empty."""
        with self._cond:
            if not self._q:
                return None
            best_i, best_p = 0, getattr(self._q[0], "priority", 0)
            for i in range(1, len(self._q)):
                p = getattr(self._q[i], "priority", 0)
                if p > best_p:
                    best_i, best_p = i, p
            if best_i == 0:
                return self._q.popleft()
            self._q.rotate(-best_i)
            req = self._q.popleft()
            self._q.rotate(best_i)
            return req

    def remove(self, req) -> bool:
        """Drop a still-queued request (cancellation before admission)."""
        with self._cond:
            try:
                self._q.remove(req)
                return True
            except ValueError:
                return False

    def remove_if(self, pred) -> list:
        """Drop and return every queued request matching ``pred``."""
        with self._cond:
            kept, removed = deque(), []
            for req in self._q:
                (removed if pred(req) else kept).append(req)
            self._q = kept
            return removed

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is non-empty (or timeout); True if work."""
        with self._cond:
            if self._q:
                return True
            self._cond.wait(timeout)
            return bool(self._q)

    def notify(self) -> None:
        """Wake the consumer (submit / drain / shutdown)."""
        with self._cond:
            self._cond.notify_all()
