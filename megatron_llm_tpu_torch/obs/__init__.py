"""Observability: per-request span tracing with Chrome trace-event export
(``trace.py``, mirror of ``megatron_llm_tpu/obs/trace.py``)."""

from .trace import TraceRecorder, device_annotation  # noqa: F401
