"""Multi-tenant LoRA serving: adapter residency over one base model
(mirror of ``megatron_llm_tpu/serving/adapters``).

``AdapterRegistry`` owns the stacked device arena that the fused decode
kernels and the composed route both read, and the LRU + ref-pinning
residency that decides which registered adapters occupy its
``EngineConfig.adapter_cache_slots`` slots.  The math and the checkpoint
format live in ``ops/lora.py``.
"""

from ...ops.lora import (DEFAULT_TARGETS, LORA_TARGETS, LoRAAdapter,
                         init_lora_adapter, load_adapter, merge_adapter,
                         save_adapter, slot_mask)
from .registry import AdapterRegistry

__all__ = [
    "AdapterRegistry",
    "LoRAAdapter",
    "LORA_TARGETS",
    "DEFAULT_TARGETS",
    "init_lora_adapter",
    "load_adapter",
    "save_adapter",
    "merge_adapter",
    "slot_mask",
]
