"""Named timers with log levels (mirror of
``megatron_llm_tpu/utils/timers.py``; reference megatron/timers.py:56-304).

Timers above the configured level are no-ops.  ``start``/``stop`` with
``barrier=True`` or ``wait_for=...`` first wait for the device: CUDA runs
asynchronously, so a host clock read without it times the enqueue.
``wait_for`` takes tensors (or anything holding them) and synchronizes the
current CUDA stream of the first CUDA tensor found; ``barrier`` synchronizes
the current device.  On the CPU both are no-ops.  One process: there is no
cross-process aggregation.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch


def _first_cuda_tensor(obj):
    if isinstance(obj, torch.Tensor):
        return obj if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for item in obj:
            found = _first_cuda_tensor(item)
            if found is not None:
                return found
    return None


def _sync(wait_for=None):
    """Wait for the device work the caller depends on."""
    if wait_for is not None:
        t = _first_cuda_tensor(wait_for)
        if t is not None:
            torch.cuda.current_stream(t.device).synchronize()
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str, log_level: int):
        self.name = name
        self.log_level = log_level
        self._elapsed = 0.0
        self._count = 0
        self._started = False
        self._start_time = 0.0

    def start(self, barrier: bool = False, wait_for=None):
        if self._started:
            raise RuntimeError(f"timer {self.name} already started")
        if barrier or wait_for is not None:
            _sync(wait_for)
        self._started = True
        self._start_time = time.perf_counter()

    def stop(self, barrier: bool = False, wait_for=None):
        if not self._started:
            raise RuntimeError(f"timer {self.name} not started")
        if barrier or wait_for is not None:
            _sync(wait_for)
        self._elapsed += time.perf_counter() - self._start_time
        self._count += 1
        self._started = False

    def reset(self):
        self._elapsed = 0.0
        self._count = 0

    def elapsed(self, reset: bool = True) -> float:
        running = self._started
        if running:
            self.stop()
        out = self._elapsed
        if reset:
            self.reset()
        if running:
            self.start()
        return out

    @property
    def count(self) -> int:
        return self._count


class _NullTimer:
    """No-op stand-in for timers above the active log level."""

    def start(self, *a, **k):
        pass

    def stop(self, *a, **k):
        pass

    def reset(self):
        pass

    def elapsed(self, reset: bool = True) -> float:
        return 0.0


_NULL = _NullTimer()


class Timers:
    """Registry of named timers (reference Timers, timers.py:185-304)."""

    def __init__(self, log_level: int = 0):
        if log_level not in (0, 1, 2):
            raise ValueError(f"log_level {log_level} not in (0, 1, 2)")
        self.log_level = log_level
        self._timers: dict[str, _Timer] = {}
        self._null_names: set[str] = set()

    def __call__(self, name: str, log_level: int = 0):
        if name in self._timers:
            return self._timers[name]
        # names above the active level stay null for good
        if name in self._null_names:
            return _NULL
        if log_level > self.log_level:
            self._null_names.add(name)
            return _NULL
        t = _Timer(name, log_level)
        self._timers[name] = t
        return t

    def elapsed_dict(self, names: Optional[Sequence[str]] = None,
                     reset: bool = True,
                     normalizer: float = 1.0) -> dict[str, float]:
        if names is None:
            names = list(self._timers)
        return {n: self._timers[n].elapsed(reset=reset) / normalizer
                for n in names if n in self._timers}

    def log(self, names: Optional[Sequence[str]] = None, *,
            normalizer: float = 1.0, reset: bool = True,
            printer=print) -> str:
        """Format and emit the '(ms)' timing line."""
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        elapsed = self.elapsed_dict(names, reset, normalizer)
        if not elapsed:
            return ""
        line = "time (ms)"
        for n, v in elapsed.items():
            line += f" | {n}: {v * 1000.0:.2f}"
        if printer is not None:
            printer(line, flush=True)
        return line

    def write(self, writer, iteration: int,
              names: Optional[Sequence[str]] = None, *,
              normalizer: Optional[float] = None, reset: bool = False):
        """Export to a tensorboard-style writer as ``timers/<name>``; the
        default ``normalizer=None`` divides each timer by its own call
        count (one-shot timers report their duration, per-iteration ones
        their time per call)."""
        if names is None:
            names = list(self._timers)
        for n in names:
            t = self._timers.get(n)
            if t is None:
                continue
            div = normalizer if normalizer is not None else max(t.count, 1)
            writer.add_scalar(f"timers/{n}", t.elapsed(reset=reset) / div,
                              iteration)
