"""Automatic prefix caching: zero-copy shared-prefix KV reuse (mirror of
``megatron_llm_tpu/serving/prefix_cache.py``).

A host-side radix trie over **block-aligned** token-id prefixes whose
nodes hold pool block ids, consulted at admission and fed at retirement.
A node covers ``block_tokens`` positions, equal to the pool's block size,
so a cached block IS a pool block: a hit places the shared block ids in
the admitted slot's table by ref bump (``SlotAllocator.insert``), and an
offer adopts blocks the retiring slot already owns by ``incref``.  No K/V
byte moves either way.  RoPE is applied at absolute positions before K
enters the pool, and a shared prefix sits at the same positions in every
sequence, so shared blocks are valid verbatim (int8 ``{q, scale}`` leaves
included).

Admission (``match_and_acquire``) pins the longest cached prefix strictly
shorter than the prompt (at least one token runs through the suffix
prefill, whose last logits seed the first sampled token); the engine
prefills only the suffix over a gathered view of the shared blocks.  The
shared blocks hold the rows a cold prefill writes, so a hit samples the
tokens a cold admission samples.

Retirement (``offer``) walks the slot's block-aligned prompt prefix into
the trie: present blocks are LRU-touched, the missing tail is adopted.
Decode appends at fill >= prompt length, so offered blocks are never
written again (a block a successor appends into is copy-on-write).

Eviction: a soft budget of ``max_blocks``; least-recently-used nodes with
no pins and no resident children go first (a middle node would orphan its
descendants), and their pool ref is dropped.  ``evict_blocks`` lets the
engine force eviction when the pool is short at admission.  With a host
tier (tiered KV, ``host_kv_blocks``) a victim spills instead: its rows
demote to host RAM and the node stays in the trie holding a host block id
(``hid``), to be promoted into a fresh pool block at its next match; when
the tier is full the least recently used childless spilled node is
dropped to make room.  A promoted hit serves the tokens a never-evicted
hit serves (the rows round-trip bitwise).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

from .block_pool import BlockPool
from .metrics import ServingMetrics


class _Node:
    """One cached block: ``key`` its ``block_tokens`` token ids, ``bid`` the
    pool block holding its rows (the trie owns one pool ref).  A spilled
    node holds ``hid``, a host-tier block id, with ``bid`` back at trash."""

    __slots__ = ("key", "parent", "children", "bid", "hid", "ref", "tick")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"]):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.bid = BlockPool.TRASH
        self.hid = None     # host-tier block id while spilled
        self.ref = 0        # live leases pinning this block
        self.tick = 0       # LRU clock at the last touch


class PrefixLease:
    """A matched chain of blocks, pinned against eviction until
    ``PrefixCache.release``: ``tokens`` matched, ``bids`` for the slot's
    table."""

    __slots__ = ("nodes", "tokens")

    def __init__(self, nodes: List[_Node], tokens: int):
        self.nodes = nodes
        self.tokens = tokens

    @property
    def bids(self) -> List[int]:
        return [n.bid for n in self.nodes]


class PrefixCache:
    """Block-granular radix cache over token-id prefixes (module doc).
    ``metrics`` is a ``ServingMetrics`` or a zero-argument callable that
    returns one (resolved at use); ``host_tier`` a ``HostKVTier`` that
    eviction victims spill to."""

    def __init__(self, *, pool: BlockPool, max_blocks: int,
                 metrics: Union[ServingMetrics, Callable, None] = None,
                 host_tier=None):
        if max_blocks < 1:
            raise ValueError("PrefixCache needs max_blocks >= 1")
        self.pool = pool
        self.block_tokens = int(pool.block_size)
        self.max_blocks = int(max_blocks)
        self._metrics = metrics
        self.host_tier = host_tier
        self._root = _Node((), None)
        self._blocks = 0
        self._host_blocks = 0
        self._tick = 0

    @property
    def blocks(self) -> int:
        """Pool blocks currently held by the trie."""
        return self._blocks

    @property
    def host_blocks(self) -> int:
        """Spilled trie blocks resident in the host tier."""
        return self._host_blocks

    def _m(self) -> Optional[ServingMetrics]:
        m = self._metrics
        return m() if callable(m) else m

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _keys(self, tokens: Sequence[int], n_blocks: int):
        b = self.block_tokens
        for i in range(n_blocks):
            yield tuple(int(t) for t in tokens[i * b:(i + 1) * b])

    # -- admission side ----------------------------------------------------

    def match_and_acquire(self,
                          tokens: Sequence[int]) -> Optional[PrefixLease]:
        """Pin and return the longest cached block-aligned prefix of
        ``tokens`` strictly shorter than it (at most ``(len - 1) // block``
        blocks), or None on a miss."""
        usable = (len(tokens) - 1) // self.block_tokens
        nodes: List[_Node] = []
        cur = self._root
        for key in self._keys(tokens, usable):
            child = cur.children.get(key)
            if child is None:
                break
            if child.hid is not None and not self._promote(child):
                # a spilled block that cannot come back now (the pool is
                # full, or a host-swap-in fault kept the host copy): the
                # match stops here and a later admission re-fetches
                break
            nodes.append(child)
            cur = child
        m = self._m()
        if not nodes:
            if m is not None:
                m.inc("prefix_misses")
            return None
        for n in nodes:
            n.ref += 1
            self._touch(n)
        matched = len(nodes) * self.block_tokens
        if m is not None:
            m.inc("prefix_hits")
            m.observe_prefix_hit_tokens(matched)
        return PrefixLease(nodes, matched)

    def release(self, lease: Optional[PrefixLease]) -> None:
        """Unpin a lease (request retired or aborted; idempotent), then
        trim blocks over the budget that the pin protected."""
        if lease is None:
            return
        nodes, lease.nodes = lease.nodes, []
        for n in nodes:
            n.ref -= 1
        if nodes:
            self._evict()

    # -- retirement side ---------------------------------------------------

    def offer(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Adopt the block-aligned prefix of ``tokens`` from a retiring
        slot's block ``table``: present blocks are LRU-touched, the missing
        ones (one contiguous tail of the walk: a node's descendants exist
        only under it) enter by pool ``incref``.  Returns the number of
        blocks adopted."""
        n_blocks = len(tokens) // self.block_tokens
        keys = list(self._keys(tokens, n_blocks))
        cur = self._root
        first_missing = n_blocks
        for i, key in enumerate(keys):
            child = cur.children.get(key)
            if child is None:
                first_missing = i
                break
            self._touch(child)
            cur = child
        for i in range(first_missing, n_blocks):
            bid = int(table[i])
            if bid == BlockPool.TRASH:
                raise RuntimeError(
                    "offered prompt prefix has an unallocated block")
            self.pool.incref(bid)
            child = _Node(keys[i], cur)
            child.bid = bid
            cur.children[keys[i]] = child
            self._touch(child)
            self._blocks += 1
            cur = child
        added = n_blocks - first_missing
        if added:
            self._evict()
        return added

    # -- host-tier spill / promote -------------------------------------------

    def _promote(self, node: _Node) -> bool:
        """Bring a spilled node's rows back into a fresh pool block; False
        (the node stays spilled, its host copy intact) when the pool has
        no block to give or the swap-in faults."""
        if not self.pool.reserve(1):
            return False
        bid = self.pool.alloc_reserved()
        try:
            self.host_tier.promote([node.hid], [bid])
        except OSError:
            self.pool.decref(bid)
            return False
        self.host_tier.free([node.hid])
        node.hid = None
        node.bid = bid
        self._host_blocks -= 1
        self._blocks += 1
        m = self._m()
        if m is not None:
            m.inc("prefix_promotions_total")
        return True

    def _spill(self, victim: _Node) -> bool:
        """Demote an eviction victim's block to the host tier, keeping the
        node as a spilled entry; a full tier first drops its least
        recently used childless spilled node.  False: the caller drops the
        victim instead."""
        tier = self.host_tier
        if tier is None:
            return False
        if not tier.can_store(1):
            self._drop_lru_spilled()
        if not tier.can_store(1) or not tier.swap_ok():
            return False
        try:
            hids = tier.begin_demote([victim.bid], owner="prefix-cache")
        except OSError:
            return False  # the device copy is untouched: a drop is safe
        self.pool.decref(victim.bid)
        victim.bid = BlockPool.TRASH
        victim.hid = hids[0]
        self._blocks -= 1
        self._host_blocks += 1
        return True

    def _drop_lru_spilled(self) -> None:
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if (n.hid is not None and not n.children
                    and (victim is None or n.tick < victim.tick)):
                victim = n
            stack.extend(n.children.values())
        if victim is None:
            return
        del victim.parent.children[victim.key]
        self.host_tier.free([victim.hid])
        victim.hid = None
        victim.parent = None
        self._host_blocks -= 1

    # -- eviction ----------------------------------------------------------

    def evict_blocks(self, n: int) -> int:
        """Evict up to ``n`` unpinned blocks whatever the budget (the pool
        is short at admission); returns how many went."""
        return self._evict(want=n)

    def _evict(self, want: int = 0) -> int:
        """LRU-evict unpinned resident blocks without resident children
        until within the budget (or, with ``want``, until that many went),
        stopping when everything left is pinned or a chain middle.  A
        spilled child does not protect its parent (spilling keeps the
        node), so whole chains can demote leaf first."""
        evicted = 0
        while (self._blocks > self.max_blocks) or (evicted < want
                                                   and self._blocks > 0):
            victim = None
            stack = list(self._root.children.values())
            while stack:
                n = stack.pop()
                if (n.ref == 0 and n.hid is None
                        and all(c.hid is not None
                                for c in n.children.values())
                        and (victim is None or n.tick < victim.tick)):
                    victim = n
                stack.extend(n.children.values())
            if victim is None:
                break
            if self._spill(victim):
                # the pool block is freed (the eviction's goal) and the
                # cached prefix survives on the host
                evicted += 1
                continue
            if victim.children:
                # neither spilled nor droppable without orphaning its
                # spilled children: stop here (the budget is soft)
                break
            del victim.parent.children[victim.key]
            self.pool.decref(victim.bid)
            victim.bid = BlockPool.TRASH
            victim.parent = None
            self._blocks -= 1
            evicted += 1
        if evicted:
            m = self._m()
            if m is not None:
                m.inc("prefix_evicted_blocks", by=evicted)
        return evicted
