"""Paged slot management: per-slot block tables over a shared block pool
(mirror of ``megatron_llm_tpu/serving/slots.py``).

A slot is a row of the decode batch that owns an int32 block table of
``T = ceil(max_seq_len / block)`` entries; unused entries point at the
trash block, so gathers and scatters always run at fixed arity.
``insert`` publishes an admission prefill's dense batch-1 cache into
freshly allocated pool blocks in one scatter; the blocks of a prefix-cache
hit enter the table by ref bump, and the first append into a shared block
copies it (``append_block_id``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..models import model as model_lib
from .block_pool import BlockPool


class SlotAllocator:
    """Slot occupancy and per-slot block tables over a ``BlockPool``.
    Only the scheduler thread touches it."""

    def __init__(self, cfg, num_slots: int, max_seq_len: int,
                 pool: BlockPool):
        if num_slots < 1 or max_seq_len < 2:
            raise ValueError("need num_slots >= 1 and max_seq_len >= 2")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.pool = pool
        bk = pool.block_size
        self.table_blocks = -(-max_seq_len // bk)
        self.width = self.table_blocks * bk
        self.tables = np.zeros((num_slots, self.table_blocks), dtype=np.int32)
        # this slot's share of the pool's outstanding reservation
        self.reserved = np.zeros(num_slots, dtype=np.int64)
        self._free = list(range(num_slots - 1, -1, -1))  # pop() -> slot 0

    # -- occupancy ---------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim a free slot index, or None when all are occupied."""
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        """Return a slot: drop one ref on every table entry, hand back any
        unused reservation, reset the row."""
        if not 0 <= slot < self.num_slots or slot in self._free:
            raise RuntimeError(f"release of a free or unknown slot {slot}")
        for bid in self.tables[slot]:
            self.pool.decref(int(bid))
        self.tables[slot] = BlockPool.TRASH
        if self.reserved[slot]:
            self.pool.unreserve(int(self.reserved[slot]))
            self.reserved[slot] = 0
        self._free.append(slot)

    def set_reservation(self, slot: int, n: int) -> None:
        """Record that ``n`` of the pool's reserved blocks belong to this
        slot (the engine already called ``pool.reserve(n)``)."""
        if self.reserved[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        self.reserved[slot] = n

    def live_bids(self, slot: int) -> List[int]:
        """The slot's allocated block ids in table order: the entries that
        are not trash form a prefix of the row (blocks are granted in fill
        order), so a demote moves them as one dense slice."""
        bids: List[int] = []
        for b in self.tables[slot]:
            if int(b) == BlockPool.TRASH:
                break
            bids.append(int(b))
        return bids

    # -- cache views ---------------------------------------------------------
    @property
    def k_pool(self):
        return self.pool.k_pool

    @property
    def v_pool(self):
        return self.pool.v_pool

    # -- admission -----------------------------------------------------------
    def insert(self, slot: int, k_small, v_small, n_tokens: int,
               shared_bids: Sequence[int] = ()) -> None:
        """Publish a dense batch-1 cache ``[L, 1, kv, width, d]`` into the
        slot's table (``claim_blocks``, then one scatter)."""
        scatter = self.claim_blocks(slot, n_tokens, shared_bids)
        model_lib.cache_scatter_blocks(self.pool.k_pool, k_small, scatter)
        model_lib.cache_scatter_blocks(self.pool.v_pool, v_small, scatter)

    def claim_blocks(self, slot: int, n_tokens: int,
                     shared_bids: Sequence[int] = ()) -> np.ndarray:
        """The slot's table for an admission of ``n_tokens``: the first
        ``len(shared_bids)`` logical blocks come from the prefix cache by
        ref bump, with zero copies; the rest of the blocks covering
        ``n_tokens`` are allocated from the slot's reservation.  Returns
        where each block of the admission's dense cache goes (the shared
        ones to the trash block, i.e. nowhere)."""
        pool = self.pool
        covered = -(-n_tokens // pool.block_size)
        n_shared = len(shared_bids)
        if covered > self.table_blocks or n_shared > covered:
            raise ValueError("insert beyond the slot's table")
        table = np.full(self.table_blocks, BlockPool.TRASH, dtype=np.int32)
        scatter = np.full(self.table_blocks, BlockPool.TRASH, dtype=np.int32)
        for i, bid in enumerate(shared_bids):
            pool.incref(int(bid))
            table[i] = bid
        for i in range(n_shared, covered):
            table[i] = scatter[i] = pool.alloc_reserved()
            self.reserved[slot] -= 1
        self.tables[slot] = table
        return scatter

    # -- decode-time lazy growth -----------------------------------------------
    def append_block_id(self, slot: int, fill: int) -> int:
        """The block that will receive the row at position ``fill``,
        allocated lazily from the slot's reservation, or copied first when
        it is shared (copy-on-write: a prefix-cache block the slot's
        prompt ends in)."""
        pool = self.pool
        i = fill // pool.block_size
        bid = int(self.tables[slot][i])
        if bid == BlockPool.TRASH:
            bid = pool.alloc_reserved()
            self.reserved[slot] -= 1
            self.tables[slot][i] = bid
        else:
            new = pool.ensure_writable(bid)
            if new != bid:
                self.reserved[slot] -= 1
                self.tables[slot][i] = bid = new
        if self.reserved[slot] < 0:
            raise RuntimeError(f"slot {slot} allocated past its reservation")
        return bid

    # -- introspection -----------------------------------------------------------
    def snapshot(self, fills: Optional[dict] = None) -> dict:
        """Host-side debug view: pool stats, tables, fragmentation."""
        pool = self.pool
        bk = pool.block_size
        slots = {}
        live_tokens = 0
        free = set(self._free)
        for s in range(self.num_slots):
            if s in free:
                continue
            row = [int(b) for b in self.tables[s]]
            fill = int(fills.get(s, 0)) if fills else 0
            live_tokens += fill
            slots[str(s)] = {"table": row, "fill": fill,
                             "blocks": sum(1 for b in row
                                           if b != BlockPool.TRASH)}
        used_tokens = pool.used_blocks * bk
        frag = (1.0 - live_tokens / used_tokens) if used_tokens else 0.0
        return {"pool": pool.stats(),
                "ref_counts": {str(k): v
                               for k, v in pool.ref_counts().items()},
                "slots": slots, "table_blocks": self.table_blocks,
                "block_size": bk, "fragmentation": frag}
