"""Deterministic fault-injection harness (mirror of
``megatron_llm_tpu/resilience/chaos.py``).

The resilience layer is instrumented with named **chaos points**
(``chaos().point("ckpt-pre-commit")`` &c.) that are inert until a test
arms the process-global controller:

- ``fail_io(site, times=n)``   the next ``n`` I/O attempts at ``site``
  raise ``OSError`` (the retry/backoff path);
- ``crash_at(site, times=n)``  raise ``SimulatedCrash`` at the point (a
  ``BaseException``, so ``except Exception`` cleanup cannot swallow it,
  as it cannot swallow a real kill);
- ``kill_at(site)``            ``os.kill(os.getpid(), SIGKILL)`` at the
  point, for subprocess tests that need a real, untrappable death;
- ``poison_batches(iters)``    the training driver NaN-poisons the batches
  of those 1-based iterations (the skip and rollback path).

Checkpoint sites: ``ckpt-begin``, ``ckpt-staging``, ``ckpt-pre-commit``,
``ckpt-pre-tracker``, ``tracker-write``, ``tracker-replace``, and the I/O
sites ``ckpt-state-save`` and ``ckpt-restore``.  The lock is a plain
``threading.Lock`` (the JAX package takes its lock from its sanitizers,
which are not ported).  Disarmed hooks cost two dict lookups.  JAX's
``hang_at`` / ``maybe_hang`` serve its serving watchdog, which is not
ported; they come with it.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable

import numpy as np


class SimulatedCrash(BaseException):
    """A chaos-injected hard crash.  Deliberately NOT an ``Exception``:
    retry loops and cleanup handlers catch ``Exception``/``OSError`` and a
    simulated kill must tear through them the way SIGKILL would."""

    def __init__(self, site: str):
        super().__init__(f"chaos: simulated crash at {site!r}")
        self.site = site


class Chaos:
    """Process-global fault-injection controller (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._io_failures: dict[str, int] = {}    # site -> remaining
        self._crashes: dict[str, int] = {}        # site -> remaining crashes
        self._kills: dict[str, int] = {}          # site -> signal number
        self._poisoned_iters: set[int] = set()
        self.events: list[tuple[str, str]] = []   # (kind, site) fired log

    # -- arming (test side) -------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._io_failures.clear()
            self._crashes.clear()
            self._kills.clear()
            self._poisoned_iters.clear()
            self.events.clear()

    def fail_io(self, site: str, times: int = 1) -> None:
        """Make the next ``times`` I/O attempts at ``site`` raise
        ``OSError``."""
        with self._lock:
            self._io_failures[site] = int(times)

    def crash_at(self, site: str, times: int = 1) -> None:
        """Raise ``SimulatedCrash`` at the next ``times`` passes through
        ``site``."""
        with self._lock:
            self._crashes[site] = int(times)

    def kill_at(self, site: str, sig: int = signal.SIGKILL) -> None:
        with self._lock:
            self._kills[site] = int(sig)

    def poison_batches(self, iterations: Iterable[int]) -> None:
        """NaN-poison the batches of these 1-based training iterations."""
        with self._lock:
            self._poisoned_iters.update(int(i) for i in iterations)

    # -- hooks (instrumented-code side; inert unless armed) -----------------

    def point(self, site: str) -> None:
        """A named crash/kill site inside instrumented code."""
        with self._lock:
            sig = self._kills.pop(site, None)
            crash = self._crashes.get(site, 0) > 0
            if crash:
                self._crashes[site] -= 1
            if sig is not None or crash:
                self.events.append(("kill" if sig is not None else "crash",
                                    site))
        if sig is not None:
            os.kill(os.getpid(), sig)
        if crash:
            raise SimulatedCrash(site)

    def io_attempt(self, site: str) -> None:
        """An I/O attempt at ``site``; raises while a failure is armed."""
        with self._lock:
            if self._io_failures.get(site, 0) <= 0:
                return
            self._io_failures[site] -= 1
            self.events.append(("fail_io", site))
        raise OSError(f"chaos: injected I/O failure at {site!r}")

    def corrupt_batch(self, batch: dict, iteration: int) -> dict:
        """Return ``batch`` NaN-poisoned iff ``iteration`` is armed."""
        with self._lock:
            poisoned = iteration in self._poisoned_iters
            if poisoned:
                self.events.append(("poison", f"iter-{iteration}"))
        return poison_nan(batch) if poisoned else batch


def poison_nan(batch: dict) -> dict:
    """A corrupted-data batch: NaN loss weights propagate to a NaN loss
    and NaN grads, exactly how a poisoned corpus shard presents to the
    step."""
    batch = dict(batch)
    mask = np.asarray(batch["loss_mask"], np.float32)
    batch["loss_mask"] = np.full_like(mask, np.nan)
    return batch


_GLOBAL = Chaos()


def chaos() -> Chaos:
    """The process-global controller the instrumented code consults."""
    return _GLOBAL
