"""Host-side resilience event counters and the eval metrics registry
(mirror of ``megatron_llm_tpu/metrics.py``).

The training driver, the checkpointing layer and the retry helper count
their events in ``RESILIENCE_EVENTS``: ``checkpoint_saves``,
``io_retries``, ``io_giveups``, ``checkpoint_fallbacks``,
``checkpoint_gc_deleted``, ``rollbacks``.  Tests read them with ``get`` or
``snapshot`` (a plain dict); ``obs.REGISTRY`` scrapes them as the
``resilience_events_total{event=...}`` family (GET
/metrics?format=prometheus).

The registry (reference megatron/metrics.py:62-110): a ``MetricInput``
with lazily derived fields and ``METRICS`` {perplexity, accuracy,
instruct_accuracy, count_loss_mask, count_instruct_mask}, evaluated in the
eval step on torch tensors (names checked by ``validate_metric_names``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .analysis.sanitizers import make_lock
from .obs.registry import REGISTRY, MetricFamily


class EventCounters:
    """Thread-safe named event counters."""

    def __init__(self):
        self._lock = make_lock("resilience.counters")
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

    def collect(self, family: str = "resilience_events_total",
                help: str = "host-side resilience event counters"
                ) -> List[MetricFamily]:
        """``obs.REGISTRY`` collector: one labelled counter family,
        ``<family>{event="<name>"}``."""
        fam = MetricFamily(family, "counter", help)
        for name, value in sorted(self.snapshot().items()):
            fam.add(value, labels={"event": name})
        return [fam]


# the process-global resilience event stream, scraped beside the serving
# metrics through the shared registry
RESILIENCE_EVENTS = EventCounters()
REGISTRY.register_collector("resilience", RESILIENCE_EVENTS.collect)


class MetricInput:
    """Lazily derived per-batch quantities shared across metrics."""

    def __init__(self, batch: dict, logits: Optional[torch.Tensor],
                 per_token_loss: torch.Tensor,
                 correct: Optional[torch.Tensor] = None):
        self.batch = batch  # tokens / labels / loss_mask (+ assistant_mask)
        self.logits = logits  # [b, s, vocab]; None when ``correct`` given
        self.per_token_loss = per_token_loss  # [b, s]
        self._predictions: Optional[torch.Tensor] = None
        self._correct = correct

    @property
    def loss_mask(self) -> torch.Tensor:
        return self.batch["loss_mask"].float()

    @property
    def assistant_mask(self) -> torch.Tensor:
        """Instruction tuning's assistant tokens: where the loss weight is
        exactly 1 (other tokens carry the scalar weight below 1)."""
        m = self.batch.get("assistant_mask")
        if m is not None:
            return m.float()
        return (self.batch["loss_mask"] >= 1.0).float()

    @property
    def predictions(self) -> torch.Tensor:
        if self._predictions is None:
            if self.logits is None:
                raise ValueError(
                    "MetricInput built without logits: only the "
                    "correctness-based metrics are available")
            self._predictions = torch.argmax(self.logits, dim=-1)
        return self._predictions

    @property
    def correct(self) -> torch.Tensor:
        if self._correct is not None:
            return self._correct
        return (self.predictions == self.batch["labels"]).float()


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def perplexity(inp: MetricInput) -> torch.Tensor:
    return torch.exp(_masked_mean(inp.per_token_loss.float(), inp.loss_mask))


def accuracy(inp: MetricInput) -> torch.Tensor:
    return _masked_mean(inp.correct, inp.loss_mask)


def instruct_accuracy(inp: MetricInput) -> torch.Tensor:
    return _masked_mean(inp.correct, inp.assistant_mask)


def count_loss_mask(inp: MetricInput) -> torch.Tensor:
    return torch.sum(inp.loss_mask)


def count_instruct_mask(inp: MetricInput) -> torch.Tensor:
    return torch.sum(inp.assistant_mask)


METRICS: Dict[str, Callable[[MetricInput], torch.Tensor]] = {
    "perplexity": perplexity,
    "accuracy": accuracy,
    "instruct_accuracy": instruct_accuracy,
    "count_loss_mask": count_loss_mask,
    "count_instruct_mask": count_instruct_mask,
}


def validate_metric_names(names) -> None:
    unknown = [n for n in names if n not in METRICS]
    if unknown:
        raise ValueError(
            f"unknown metrics {unknown}; available: {sorted(METRICS)}")


def compute_metrics(names, batch: dict, logits: Optional[torch.Tensor],
                    per_token_loss: torch.Tensor,
                    correct: Optional[torch.Tensor] = None
                    ) -> dict[str, torch.Tensor]:
    inp = MetricInput(batch, logits, per_token_loss, correct=correct)
    return {n: METRICS[n](inp) for n in names}
