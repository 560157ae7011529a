"""Adapter registry and arena residency (LRU + ref pinning), the mirror of
``megatron_llm_tpu/serving/adapters/registry.py``.

The registry answers one question for the engine's admission: which arena
slot holds this request's adapter?  ``acquire`` pins the adapter for the
life of the engine slot (``release`` at retirement), installing it into a
free or the least recently used unpinned slot on a miss.  When every slot
is pinned, ``acquire`` returns ``None`` and the engine parks the request
at the queue head, as it does under KV pool pressure.

The arena is ``ops/lora.py``'s: one ``A [L, in, n_slots·r]`` / ``B [L,
n_slots·r, out]`` pair per target on the engine's device, α/r folded into
B at install.  An install writes the slot's columns in place (the tensors,
and so their storage, stay the same), and the hot path reads the arena
with a per-row slot vector: no per-request factor tensor is built.

One lock guards the host-side maps (``make_lock``: order-tracked under
the sanitizers).  The engine calls acquire and release from its scheduler
thread; tests and tools may call them too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Union

from ...analysis.sanitizers import make_lock
from ...ops import lora as lora_lib
from ..metrics import ServingMetrics


class AdapterRegistry:
    """LoRA adapter store and device-arena residency for one engine.

    ``n_slots`` arena slots (``EngineConfig.adapter_cache_slots``); every
    adapter shares one ``rank`` and one target set (one arena, one kernel
    geometry).  Any number of adapters may be registered on the host; at
    most ``n_slots`` are resident at once.  The arena lives on ``device``
    (default ``cuda``; the engine's device)."""

    def __init__(self, cfg, n_slots: int, rank: int, targets=None, *,
                 metrics: Union[ServingMetrics, Callable, None] = None,
                 device=None):
        import torch

        if n_slots < 1:
            raise ValueError("AdapterRegistry needs n_slots >= 1")
        if rank < 1:
            raise ValueError("AdapterRegistry needs rank >= 1")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.rank = int(rank)
        self.targets = (tuple(targets) if targets is not None
                        else lora_lib.DEFAULT_TARGETS)
        unknown = [t for t in self.targets
                   if t not in lora_lib.lora_target_shapes(cfg)]
        if unknown:
            raise ValueError(f"unknown LoRA targets {unknown}")
        if cfg.num_experts > 0:
            moe = [t for t in self.targets
                   if t in ("w_gate", "w_up", "w_down")]
            if moe:
                # the MoE dispatch routes tokens through per-expert weights
                # the stacked arena does not model: refuse up front
                raise ValueError(
                    f"LoRA MLP targets {moe} unsupported with MoE "
                    f"(num_experts={cfg.num_experts}); use attention "
                    "targets only")
        self.device = torch.device("cuda" if device is None else device)
        self._lock = make_lock("serving.adapters")
        # like PrefixCache: the engine may replace its metrics object, so a
        # zero-argument callable defers the lookup to use time
        self._metrics = metrics
        self._store: Dict[str, lora_lib.LoRAAdapter] = {}
        self._slot_of: Dict[str, int] = {}        # resident id -> slot
        self._ids: list = [None] * self.n_slots   # slot -> id | None
        self._refs: list = [0] * self.n_slots     # pin counts
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # unpinned
        self._free: list = list(range(self.n_slots - 1, -1, -1))
        self.arenas = lora_lib.make_arenas(cfg, self.n_slots, self.rank,
                                           self.targets, device=self.device)

    # -- host-side store ---------------------------------------------------

    def register(self, adapter_id: str,
                 adapter: lora_lib.LoRAAdapter) -> None:
        """Add (or replace) an adapter in the host-side store.  Every
        adapter shares the registry's rank and targets; replacing a
        resident adapter is refused (register the update under a new
        id)."""
        if adapter.rank != self.rank:
            raise ValueError(
                f"adapter {adapter_id!r} rank {adapter.rank} != registry "
                f"rank {self.rank}")
        if set(adapter.targets) != set(self.targets):
            raise ValueError(
                f"adapter {adapter_id!r} targets {adapter.targets} != "
                f"registry targets {self.targets}")
        lora_lib.validate_adapter(self.cfg, adapter)
        with self._lock:
            if adapter_id in self._slot_of:
                raise ValueError(
                    f"adapter {adapter_id!r} is arena-resident; "
                    "register updates under a new id")
            self._store[adapter_id] = adapter

    def register_path(self, adapter_id: str, path: str) -> None:
        """Load an adapter checkpoint directory and register it."""
        self.register(adapter_id, lora_lib.load_adapter(path))

    def known(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._store

    def clone(self) -> "AdapterRegistry":
        """A fresh registry (its own arena, no residency, no pins) sharing
        this one's host-side store: one per engine replica."""
        out = AdapterRegistry(self.cfg, self.n_slots, self.rank,
                              self.targets, device=self.device)
        with self._lock:
            out._store = dict(self._store)
        return out

    @property
    def sr(self) -> int:
        """Total stacked rank of the arena (n_slots · rank)."""
        return self.n_slots * self.rank

    # -- residency ---------------------------------------------------------

    def acquire(self, adapter_id: str) -> Optional[int]:
        """Pin ``adapter_id`` and return its arena slot; ``None`` when
        every slot is pinned by other adapters (the caller parks and
        retries).  Raises ``KeyError`` for an unregistered id."""
        with self._lock:
            adapter = self._store.get(adapter_id)
            if adapter is None:
                raise KeyError(f"unknown adapter {adapter_id!r}")
            slot = self._slot_of.get(adapter_id)
            if slot is not None:
                self._refs[slot] += 1
                self._lru.pop(adapter_id, None)
                self._inc("adapter_hits")
                return slot
            slot = self._evict_or_free()
            self._inc("adapter_misses")
            if slot is None:
                return None
            self._inc("adapter_installs")
            self._ids[slot] = adapter_id
            self._slot_of[adapter_id] = slot
            self._refs[slot] = 1
            lora_lib.install_adapter(self.arenas, adapter.factors, slot,
                                     adapter.scale, self.rank)
            self._gauges()
            return slot

    def release(self, adapter_id: str) -> None:
        """Drop one pin.  The adapter stays resident (an LRU candidate)
        until eviction pressure takes its slot."""
        with self._lock:
            slot = self._slot_of.get(adapter_id)
            if slot is None:
                return
            self._refs[slot] = max(0, self._refs[slot] - 1)
            if self._refs[slot] == 0:
                self._lru[adapter_id] = None
                self._lru.move_to_end(adapter_id)

    def _evict_or_free(self) -> Optional[int]:
        """A free slot, else the least recently used unpinned resident's
        (lock held by the caller).  The caller's install overwrites the
        slot's columns."""
        if self._free:
            return self._free.pop()
        if not self._lru:
            return None
        victim, _ = self._lru.popitem(last=False)
        slot = self._slot_of.pop(victim)
        self._ids[slot] = None
        self._refs[slot] = 0
        self._inc("adapter_evictions")
        return slot

    # -- introspection -----------------------------------------------------

    def resident(self) -> Dict[str, int]:
        """adapter_id -> arena slot of every resident adapter."""
        with self._lock:
            return dict(self._slot_of)

    def is_resident(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._slot_of

    def pins(self, adapter_id: str) -> int:
        with self._lock:
            slot = self._slot_of.get(adapter_id)
            return 0 if slot is None else self._refs[slot]

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(self._store[a].nbytes for a in self._slot_of)

    # -- metrics -----------------------------------------------------------

    def _m(self) -> Optional[ServingMetrics]:
        m = self._metrics
        return m() if callable(m) and not isinstance(
            m, ServingMetrics) else m

    def _inc(self, name: str) -> None:
        m = self._m()
        if m is not None:
            m.inc(name)

    def _gauges(self) -> None:
        m = self._m()
        if m is not None:
            m.set_gauges(
                adapter_resident=len(self._slot_of),
                adapter_resident_bytes=sum(
                    self._store[a].nbytes for a in self._slot_of))
