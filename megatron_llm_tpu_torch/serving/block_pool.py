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
``cow_copies_total``).  ``export_blocks`` / ``import_blocks`` move a
block-table-ordered slice of blocks out of and into the pool, int8
``{"q", "scale"}`` leaves verbatim; the host tier below moves blocks
through them.  Under a serving mesh (``mesh=``) each rank holds only its
slice of the pool, ``[L/pp, n_blocks, kv/tp, block, d]``
(``models/sharding.kv_pool_specs``); block ids are the same on every
rank, so the ledger is one, on rank 0.

``HostKVTier`` is tiered KV's host-RAM arena behind the pool (JAX
``HostKVTier``, on pinned host tensors): asynchronous demotes (a gather on
the compute stream, then non-blocking device-to-host copies on a side
stream), synchronous promotes, its own conservation ledger and a measured
swap bandwidth.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import model as model_lib
from ..parallel.mesh import use_mesh
from ..resilience.chaos import chaos


def _leaves(cache) -> list:
    """The tensors of a pool or dense cache (the int8 form's two)."""
    return list(cache.values()) if isinstance(cache, dict) else [cache]


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
                 on_cow: Optional[Callable[[], None]] = None, mesh=None):
        if n_blocks < 2:
            raise ValueError("BlockPool needs at least 2 blocks "
                             "(one is the reserved trash block)")
        self.cfg = cfg
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.device = model_lib.default_device(device)
        self.mesh = mesh
        # this rank's slice under a serving mesh (``kv_pool_specs``: layers
        # over pp, kv heads over tp; a stack whose layers do not divide pp
        # keeps them whole)
        with use_mesh(mesh) if mesh is not None else nullcontext():
            self.k_pool, self.v_pool = model_lib.init_kv_pool(
                cfg, n_blocks, block_size, device=self.device)
        # copy-on-write's device copy (``copy``); the sharded engine sends
        # it to every rank
        self.copier: Optional[Callable[[int, int], None]] = None
        self._ref = np.zeros(n_blocks, dtype=np.int32)
        self._ref[self.TRASH] = 1  # permanently pinned
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._reserved = 0
        self.on_cow = on_cow
        self.cow_copies = 0

    def copy(self, src: int, dst: int) -> None:
        """Block ``src``'s rows onto block ``dst``, K and V, every leaf."""
        copy_block(self.k_pool, src, dst)
        copy_block(self.v_pool, src, dst)

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
            (self.copier or self.copy)(bid, new)
            self.decref(bid)
            self.cow_copies += 1
            if self.on_cow is not None:
                self.on_cow()
        return new

    # -- moving blocks out and in --------------------------------------------
    def export_blocks(self, bids: Sequence[int], arity: int):
        """Gather ``bids`` into dense table-ordered leaves ``[L, 1, kv,
        arity * block(, d)]`` (new tensors on the pool's device), in the
        pool's own dtypes: int8 ``{"q", "scale"}`` leaves move quantized.
        Columns past ``len(bids)`` read the trash block."""
        if len(bids) > arity:
            raise ValueError(f"{len(bids)} blocks exceed the arity {arity}")
        chaos().io_attempt("ship-export")
        table = np.full((1, arity), self.TRASH, dtype=np.int64)
        table[0, :len(bids)] = np.asarray(bids, dtype=np.int64)
        table = torch.from_numpy(table).to(model_lib._leaf(self.k_pool).device)
        return (model_lib.cache_gather_blocks(self.k_pool, table),
                model_lib.cache_gather_blocks(self.v_pool, table))

    def import_blocks(self, k_dense, v_dense, scatter) -> None:
        """Scatter dense table-ordered leaves into this pool: column group
        i lands in block ``scatter[i]`` (trash for pad columns).  The
        leaves may live elsewhere (pinned host memory): each is copied to
        the pool's device first.  The pool's tensors are written in place
        and never rebound, so the fused kernels' operands keep their
        addresses; the bytes move verbatim."""
        chaos().io_attempt("ship-import")
        dev = model_lib._leaf(self.k_pool).device
        scatter = torch.as_tensor(np.asarray(scatter, dtype=np.int64))

        def to_pool(dense):
            return model_lib._leafwise(
                lambda a: a.to(dev, non_blocking=True), dense)

        model_lib.cache_scatter_blocks(self.k_pool, to_pool(k_dense),
                                       scatter.to(dev))
        model_lib.cache_scatter_blocks(self.v_pool, to_pool(v_dense),
                                       scatter.to(dev))

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


class _PendingSwap:
    """One in-flight demote: the gathered block-major device rows (the
    only owner of the bytes once the source blocks are freed, kept alive
    here until the copies are done) and the events around the copies."""

    __slots__ = ("hids", "rows", "start", "done", "nbytes", "host_s")

    def __init__(self, hids, rows, start, done, nbytes, host_s):
        self.hids = hids
        self.rows = rows
        self.start = start
        self.done = done
        self.nbytes = nbytes
        self.host_s = host_s


def _to_block_major(dense, n: int, bk: int) -> torch.Tensor:
    """Table-ordered dense ``[L, 1, kv, n * bk(, d)]`` → ``[n, L, kv, bk(,
    d)]``, contiguous: block i's rows in one piece."""
    L, _, kv = dense.shape[:3]
    tail = tuple(dense.shape[4:])
    x = dense[:, 0].reshape((L, kv, n, bk) + tail)
    return x.movedim(2, 0).contiguous()


def _from_block_major(rows: torch.Tensor) -> torch.Tensor:
    """The inverse: ``[n, L, kv, bk(, d)]`` → ``[L, 1, kv, n * bk(, d)]``."""
    n, L, kv, bk = rows.shape[:4]
    tail = tuple(rows.shape[4:])
    return rows.movedim(0, 2).reshape((L, 1, kv, n * bk) + tail)


class HostKVTier:
    """Host-RAM tier of KV blocks behind a device ``BlockPool`` (mirror of
    JAX's ``HostKVTier``).

    The arenas hold the pool's leaves block-major, ``[n_host, L, kv,
    block(, d)]`` (JAX mirrors the pool's ``[L, n, ...]``): a block's rows
    are one contiguous piece of host memory, so a copy lands in the arena
    directly and asynchronously, with no staging buffer and no host-side
    copy.  They are allocated once, pinned when the pool is on a CUDA
    device (a failed pin raises).  Blocks move out through
    ``export_blocks`` and in through ``import_blocks``, in table order,
    int8 ``{q, scale}`` leaves verbatim, so round trips are bitwise; a
    move gathers exactly its blocks (there is nothing to compile, so no
    pad columns cross the bus).

    Demotes are asynchronous: ``begin_demote`` enqueues the gather (and a
    transpose to block-major rows) on the compute stream and, on a side
    stream that first waits for them, one non-blocking copy a block into
    its arena row, then returns.  The caller frees the source blocks at
    once: the gather was enqueued before any later step that may write
    them, and the gathered rows, kept in ``_PendingSwap`` and recorded on
    the side stream, own the bytes until the copies are done.  ``pump``
    (the scheduler's host phase) retires finished demotes.  Promotes are
    synchronous for the scheduler: non-blocking host-to-device copies of
    the arena rows and ``import_blocks`` on the compute stream.  A demote
    into an arena row a promote still reads is ordered after it, since
    the side stream waits for the compute stream first.

    Chaos sites: ``host-swap-out`` fires before any state changes (the
    device copy is never lost), ``host-swap-in`` before the import (the
    host copy stays for a later re-fetch).  The tier keeps its own ledger
    (free list and owner map, audited by the ``LedgerSanitizer``) and an
    EWMA of the measured swap bandwidth that bounds oversubscribed
    admission (``swap_ok``)."""

    def __init__(self, pool: BlockPool, n_host_blocks: int, arity: int,
                 metrics=None, max_backlog_s: float = 0.25):
        if n_host_blocks < 1:
            raise ValueError("HostKVTier needs n_host_blocks >= 1")
        self.pool = pool
        self.n_host_blocks = int(n_host_blocks)
        self.arity = int(arity)
        # a ServingMetrics or a zero-argument callable returning one
        self._metrics = metrics
        self.max_backlog_s = float(max_backlog_s)
        self.device = model_lib._leaf(pool.k_pool).device
        self._cuda = self.device.type == "cuda"

        def arena(leaf):
            shape = (self.n_host_blocks, leaf.shape[0]) + tuple(leaf.shape[2:])
            return torch.zeros(shape, dtype=leaf.dtype,
                               pin_memory=self._cuda)

        self.k_arena = model_lib._leafwise(arena, pool.k_pool)
        self.v_arena = model_lib._leafwise(arena, pool.v_pool)
        self.block_nbytes = sum(
            a[0].numel() * a.element_size()
            for a in _leaves(self.k_arena) + _leaves(self.v_arena))
        self._free: List[int] = list(range(self.n_host_blocks - 1, -1, -1))
        self._owner: dict = {}          # hid -> owner label
        self._pending: List[_PendingSwap] = []
        self._inflight_hids: set = set()
        self._stream = None             # the side stream, made at first use
        # optimistic seed: the first oversubscribed admission is not
        # starved before any measurement exists
        self.bw_bytes_per_s = float("inf")
        self.swaps_out = 0
        self.swaps_in = 0

    # -- bookkeeping ---------------------------------------------------------
    @property
    def host_free(self) -> int:
        return len(self._free)

    @property
    def host_used(self) -> int:
        return self.n_host_blocks - len(self._free)

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def can_store(self, n: int) -> bool:
        return len(self._free) >= n

    def _m(self):
        m = self._metrics
        return m() if callable(m) else m

    def owners(self) -> dict:
        """owner label -> host block count."""
        out: dict = {}
        for owner in self._owner.values():
            out[owner] = out.get(owner, 0) + 1
        return out

    def free(self, hids: Sequence[int]) -> None:
        for hid in hids:
            hid = int(hid)
            if hid not in self._owner:
                raise RuntimeError(f"double free of host block {hid}")
            if hid in self._inflight_hids:
                raise RuntimeError(f"freeing host block {hid} mid-swap")
            del self._owner[hid]
            self._free.append(hid)

    def swap_ok(self) -> bool:
        """Whether the demote backlog is within ``max_backlog_s`` of the
        measured bandwidth: the bound of oversubscribed admission."""
        backlog = sum(p.nbytes for p in self._pending)
        if backlog == 0:
            return True
        if self.bw_bytes_per_s == float("inf"):
            return len(self._pending) <= 2
        return backlog / self.bw_bytes_per_s <= self.max_backlog_s

    # -- demote (device -> host), asynchronous --------------------------------
    def begin_demote(self, bids: Sequence[int], owner: str) -> List[int]:
        """Start swapping ``bids`` out and return their host block ids at
        once; the caller may free the source blocks.  Raises ``OSError``
        when the ``host-swap-out`` chaos site is armed, before any state
        changes."""
        if not 1 <= len(bids) <= self.arity:
            raise ValueError(f"demote of {len(bids)} blocks (arity "
                             f"{self.arity})")
        if not self.can_store(len(bids)):
            raise RuntimeError("host tier exhausted")
        chaos().io_attempt("host-swap-out")
        n, bk = len(bids), self.pool.block_size
        k_dense, v_dense = self.pool.export_blocks(bids, n)
        rows = [_to_block_major(d, n, bk)
                for d in _leaves(k_dense) + _leaves(v_dense)]
        hids = [self._free.pop() for _ in bids]
        arenas = _leaves(self.k_arena) + _leaves(self.v_arena)
        start = done = None
        t0 = time.perf_counter()
        if self._cuda:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            side = self._stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                for arena, r in zip(arenas, rows):
                    for i, hid in enumerate(hids):
                        arena[hid].copy_(r[i], non_blocking=True)
                    r.record_stream(side)
                done.record(side)
        else:
            for arena, r in zip(arenas, rows):
                for i, hid in enumerate(hids):
                    arena[hid].copy_(r[i])
        for hid in hids:
            self._owner[hid] = owner
            self._inflight_hids.add(hid)
        nbytes = self.block_nbytes * n
        self._pending.append(_PendingSwap(hids, rows, start, done, nbytes,
                                          time.perf_counter() - t0))
        m = self._m()
        if m is not None:
            m.inc("swap_out_blocks_total", by=n)
            m.inc("swap_bytes_total", by=nbytes)
        self.swaps_out += n
        return hids

    def _finalize(self, swap: _PendingSwap) -> None:
        """Wait for one demote's copies and retire it; the bandwidth sample
        is the copies' device time (their enqueue time on the CPU)."""
        dt = swap.host_s
        if swap.done is not None:
            swap.done.synchronize()
            dt = swap.start.elapsed_time(swap.done) / 1e3
        swap.rows = None
        for hid in swap.hids:
            self._inflight_hids.discard(hid)
        bw = swap.nbytes / max(dt, 1e-9)
        self.bw_bytes_per_s = (bw if self.bw_bytes_per_s == float("inf")
                               else 0.8 * self.bw_bytes_per_s + 0.2 * bw)

    def pump(self, max_swaps: Optional[int] = None) -> int:
        """Retire finished demotes (the scheduler's host phase); returns
        how many."""
        done = 0
        while self._pending and (max_swaps is None or done < max_swaps):
            self._finalize(self._pending.pop(0))
            done += 1
        return done

    def _ensure_resident(self, hids: Sequence[int]) -> None:
        want = {int(h) for h in hids}
        while want & self._inflight_hids:
            self._finalize(self._pending.pop(0))

    # -- promote (host -> device) ---------------------------------------------
    def promote(self, hids: Sequence[int], dest_bids: Sequence[int]) -> None:
        """Swap host blocks back into freshly allocated pool blocks,
        bitwise.  Raises ``OSError`` when the ``host-swap-in`` chaos site
        is armed; the host copy stays resident, and the caller unwinds its
        device allocations."""
        if len(hids) != len(dest_bids) or len(hids) > self.arity:
            raise ValueError("promote needs one destination block per "
                             f"host block, at most {self.arity}")
        self._ensure_resident(hids)
        chaos().io_attempt("host-swap-in")
        n = len(hids)

        def gather(arena):
            rows = torch.empty((n,) + tuple(arena.shape[1:]),
                               dtype=arena.dtype, device=self.device)
            for i, hid in enumerate(hids):
                rows[i].copy_(arena[int(hid)], non_blocking=True)
            return _from_block_major(rows)

        self.pool.import_blocks(model_lib._leafwise(gather, self.k_arena),
                                model_lib._leafwise(gather, self.v_arena),
                                np.asarray(dest_bids, dtype=np.int64))
        nbytes = self.block_nbytes * n
        m = self._m()
        if m is not None:
            m.inc("swap_in_blocks_total", by=n)
            m.inc("swap_bytes_total", by=nbytes)
        self.swaps_in += n

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        return {
            "n_host_blocks": self.n_host_blocks,
            "host_blocks_used": self.host_used,
            "host_blocks_free": self.host_free,
            "swaps_in_flight": self.in_flight,
            "swap_bw_bytes_per_s": (
                0.0 if self.bw_bytes_per_s == float("inf")
                else self.bw_bytes_per_s),
            "swap_out_blocks": self.swaps_out,
            "swap_in_blocks": self.swaps_in,
            "owners": self.owners(),
        }
