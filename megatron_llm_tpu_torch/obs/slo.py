"""Rolling-window SLO tracking with burn-rate gauges (mirror of
``megatron_llm_tpu/obs/slo.py``).

Three objectives, matched to what a serving router's health check needs:

- **TTFT**: fraction of first tokens under ``ttft_target_s`` must stay
  above ``ttft_objective`` (e.g. 99% under 1s).
- **ITL**: fraction of decode-iteration token latencies under
  ``itl_target_s`` must stay above ``itl_objective``.
- **Availability**: fraction of requests finishing without timeout/error
  must stay above ``availability_target``.

Each dimension keeps a deque of ``(t, good, total)`` observations pruned
to the last ``window_s`` seconds; compliance is windowed good/total.
The **burn rate** is the standard multi-window-alert quantity:
``(1 - compliance) / (1 - objective)`` — 1.0 means the error budget is
being consumed exactly at the sustainable rate, >1 means the SLO will be
violated if the window's behavior continues, and a router should stop
routing new work to a replica whose burn rate is persistently high.

Empty windows report compliance 1.0 / burn 0.0: an idle replica is a
healthy replica.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List

from ..analysis.sanitizers import make_lock
from .registry import MetricFamily


@dataclass(frozen=True)
class SLOConfig:
    ttft_target_s: float = 1.0        # first token under this ...
    ttft_objective: float = 0.99      # ... for this fraction of requests
    itl_target_s: float = 0.25        # inter-token latency under this ...
    itl_objective: float = 0.99       # ... for this fraction of tokens
    availability_target: float = 0.999  # fraction finishing ok
    window_s: float = 300.0           # rolling evaluation window


class _Window:
    """Deque of (t, good, total) pruned to the trailing window."""

    __slots__ = ("_q", "_good", "_total", "window_s")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._q: deque = deque()
        self._good = 0
        self._total = 0

    def record(self, now: float, good: int, total: int) -> None:
        self._q.append((now, good, total))
        self._good += good
        self._total += total
        self.prune(now)

    def prune(self, now: float) -> None:
        cutoff = now - self.window_s
        q = self._q
        while q and q[0][0] < cutoff:
            _, g, t = q.popleft()
            self._good -= g
            self._total -= t

    def stats(self, now: float) -> Dict[str, float]:
        self.prune(now)
        compliance = self._good / self._total if self._total else 1.0
        return {"good": self._good, "total": self._total,
                "compliance": compliance}


class SLOTracker:
    """Thread-safe rolling-window tracker for TTFT / ITL / availability."""

    DIMENSIONS = ("ttft", "itl", "availability")

    def __init__(self, config: SLOConfig = SLOConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self._clock = clock
        self._lock = make_lock("obs.slo")
        self._windows = {d: _Window(config.window_s) for d in self.DIMENSIONS}

    def _objective(self, dim: str) -> float:
        c = self.config
        return {"ttft": c.ttft_objective, "itl": c.itl_objective,
                "availability": c.availability_target}[dim]

    def record_ttft(self, seconds: float) -> None:
        with self._lock:
            self._windows["ttft"].record(
                self._clock(), int(seconds <= self.config.ttft_target_s), 1)

    def record_itl(self, seconds: float, n: int = 1) -> None:
        """One decode iteration: ``n`` tokens each at ``seconds`` latency."""
        with self._lock:
            good = n if seconds <= self.config.itl_target_s else 0
            self._windows["itl"].record(self._clock(), good, n)

    def record_request(self, ok: bool) -> None:
        with self._lock:
            self._windows["availability"].record(
                self._clock(), int(bool(ok)), 1)

    def compliance(self, dim: str) -> float:
        with self._lock:
            return self._windows[dim].stats(self._clock())["compliance"]

    def burn_rate(self, dim: str) -> float:
        budget = 1.0 - self._objective(dim)
        if budget <= 0:
            return 0.0
        return (1.0 - self.compliance(dim)) / budget

    def healthy(self, max_burn: float = 1.0) -> bool:
        """True when every dimension burns budget at a sustainable rate."""
        return all(self.burn_rate(d) <= max_burn for d in self.DIMENSIONS)

    def snapshot(self) -> Dict:
        now_stats = {}
        with self._lock:
            now = self._clock()
            for dim, w in self._windows.items():
                now_stats[dim] = w.stats(now)
        out: Dict = {"window_s": self.config.window_s}
        for dim, st in now_stats.items():
            budget = 1.0 - self._objective(dim)
            burn = ((1.0 - st["compliance"]) / budget) if budget > 0 else 0.0
            out[dim] = {"compliance": st["compliance"],
                        "burn_rate": burn,
                        "objective": self._objective(dim),
                        "good": st["good"], "total": st["total"]}
        out["ttft"]["target_s"] = self.config.ttft_target_s
        out["itl"]["target_s"] = self.config.itl_target_s
        out["healthy"] = all(out[d]["burn_rate"] <= 1.0
                             for d in self.DIMENSIONS)
        return out

    def collect(self, prefix: str = "slo") -> List[MetricFamily]:
        """Registry-collector rows: compliance + burn-rate gauges."""
        snap = self.snapshot()
        comp = MetricFamily(
            f"{prefix}_compliance", "gauge",
            "windowed fraction of observations meeting the SLO target")
        burn = MetricFamily(
            f"{prefix}_burn_rate", "gauge",
            "error-budget burn rate; >1 means the SLO is being violated")
        for dim in self.DIMENSIONS:
            comp.add(snap[dim]["compliance"], labels={"slo": dim})
            burn.add(snap[dim]["burn_rate"], labels={"slo": dim})
        healthy = MetricFamily(
            f"{prefix}_healthy", "gauge",
            "1 when every SLO dimension burns budget sustainably")
        healthy.add(1.0 if snap["healthy"] else 0.0)
        return [comp, burn, healthy]
