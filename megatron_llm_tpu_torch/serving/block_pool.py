"""Device-resident paged KV block pool with host-side bookkeeping (mirror of
``megatron_llm_tpu/serving/block_pool.py``'s ``BlockPool``).

The pool owns two tensors (K and V) ``[L, n_blocks, kv_heads, block, d]``
(with ``kv_cache_quant="int8"`` two ``{"q", "scale"}`` pairs, built by
``models/model.init_kv_pool``; the block accounting is the same); free list, ref counts and reservations live on the host.  Block 0 is the
permanently allocated trash block that unused table entries point at;
decode attention masks everything past a row's fill, so trash contents
never reach an output.  Reservations make admission sound: a request
reserves its worst-case block count up front and per-step allocation
draws from it, so a decode step never runs out of blocks.  Blocks are
ref-counted: the prefix cache holds a ref on every block it caches and a
slot's table one per entry, and ``ensure_writable`` copies a shared block
before a slot appends into it (copy-on-write, counted in
``cow_copies_total``).

Not in this slice: block export/import for shipping and the host-RAM
tier (``HostKVTier``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import model as model_lib


def copy_block(pool, src: int, dst: int) -> None:
    """Copy block ``src`` of every leaf onto block ``dst`` in place (the
    int8 ``{"q", "scale"}`` form leaf by leaf; JAX ``_copy_block_plain``)."""
    leaves = pool.values() if isinstance(pool, dict) else (pool,)
    for a in leaves:
        idx = torch.tensor([dst], device=a.device)
        a.index_copy_(1, idx, a[:, src:src + 1])


class BlockPool:
    """Fixed pool of KV blocks + free-list / ref-count / reservation state.
    ``n_blocks`` includes the trash block 0."""

    TRASH = 0

    def __init__(self, cfg, n_blocks: int, block_size: int, device=None,
                 on_cow: Optional[Callable[[], None]] = None):
        if n_blocks < 2:
            raise ValueError("BlockPool needs at least 2 blocks "
                             "(one is the reserved trash block)")
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.k_pool, self.v_pool = model_lib.init_kv_pool(
            cfg, n_blocks, block_size, device=device)
        self._ref = np.zeros(n_blocks, dtype=np.int32)
        self._ref[self.TRASH] = 1  # permanently pinned
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._reserved = 0
        self._on_cow = on_cow
        self.cow_copies = 0

    # -- capacity / reservations ------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def can_reserve(self, n: int) -> bool:
        return len(self._free) - self._reserved >= n

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` blocks for future allocation; False if the pool
        cannot guarantee them right now."""
        if not self.can_reserve(n):
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if self._reserved < n:
            raise RuntimeError("unreserve() exceeds reservation")
        self._reserved -= n

    # -- alloc / ref counting ----------------------------------------------
    def alloc_reserved(self) -> int:
        """Allocate one block against an existing reservation."""
        if self._reserved <= 0:
            raise RuntimeError("alloc_reserved() without reservation")
        self._reserved -= 1
        if not self._free:
            raise RuntimeError("BlockPool exhausted despite reservation")
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        if bid == self.TRASH or self._ref[bid] <= 0:
            raise RuntimeError(f"incref on unallocated block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        if bid == self.TRASH:
            return
        if self._ref[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    def ref(self, bid: int) -> int:
        return int(self._ref[bid])

    # -- copy-on-write -------------------------------------------------------
    def ensure_writable(self, bid: int) -> int:
        """A block id safe to append rows into: ``bid`` itself when this
        caller owns it alone; else (shared, or the trash block) a fresh
        block from the caller's reservation, holding a device copy of
        ``bid``'s rows, with the caller's ref on ``bid`` dropped."""
        if bid != self.TRASH and self._ref[bid] == 1:
            return bid
        new = self.alloc_reserved()
        if bid != self.TRASH:
            copy_block(self.k_pool, bid, new)
            copy_block(self.v_pool, bid, new)
            self.decref(bid)
            self.cow_copies += 1
            if self._on_cow is not None:
                self._on_cow()
        return new

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        used = self.used_blocks
        usable = self.usable_blocks
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "blocks_free": self.free_blocks,
            "blocks_used": used,
            "blocks_reserved": self._reserved,
            "kv_cache_util": (used / usable) if usable else 0.0,
        }

    def ref_counts(self) -> dict:
        """Non-zero ref counts by block id (trash excluded)."""
        return {int(b): int(self._ref[b])
                for b in np.nonzero(self._ref)[0] if b != self.TRASH}
