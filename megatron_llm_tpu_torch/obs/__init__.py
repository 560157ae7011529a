"""Observability (mirror of ``megatron_llm_tpu/obs``): one process-wide
home for the signals the serving and training stacks emit.

- ``registry``: labelled counters / gauges / histograms and scrape-time
  collectors, exported in the Prometheus text format (``GET
  /metrics?format=prometheus``).
- ``trace``: a ring of per-request and per-iteration spans, exported as
  Chrome trace-event JSON (``GET /trace``), named on the card's timeline
  with NVTX ranges.
- ``logging``: the rank-aware structured JSON event log whose lines carry
  ``request_id`` correlation ids.
- ``slo``: rolling-window TTFT / ITL / availability objectives with
  burn-rate gauges.

All host-side; everything but ``trace`` (NVTX) is stdlib only.
"""

from .logging import EVENT_LOG, StructuredLog
from .registry import (REGISTRY, Counter, Gauge, Histogram, MetricFamily,
                       MetricsRegistry, Sample)
from .slo import SLOConfig, SLOTracker
from .trace import TraceRecorder, device_annotation

__all__ = [
    "Counter",
    "EVENT_LOG",
    "Gauge",
    "Histogram",
    "MetricFamily",
    "MetricsRegistry",
    "REGISTRY",
    "Sample",
    "SLOConfig",
    "SLOTracker",
    "StructuredLog",
    "TraceRecorder",
    "device_annotation",
]
