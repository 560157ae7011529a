"""REALM evidence-index builder: one pass over an evidence corpus, the
context tower's embeddings in batches, sharded save and merge (mirror of
``megatron_llm_tpu/models/realm_indexer.py``).

Reference parity: megatron/indexer.py (IndexBuilder) and
megatron/data/realm_index.py (OpenRetreivalDataStore); FAISS is replaced
by exact maximum-inner-product search, one ``[queries, dim] · [dim,
blocks]`` product.  The store keys embeddings by ``block_id``, the id
``build_blocks_mapping`` gives each block and every ``ICTDataset`` sample
carries in its ``block_data`` row.  Shards and the merged store are the
JAX package's ``.npz`` files (``ids`` int64, ``vecs``), so either package
reads the other's.  A build over several processes gives each a
``rank``/``world`` slice of the rows and waits at a ``torch.distributed``
barrier before rank 0 merges.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from . import biencoder

logger = logging.getLogger(__name__)


class BlockDataStore:
    """block_id → embedding store with shard/merge semantics (reference
    OpenRetreivalDataStore, realm_index.py:17-116)."""

    def __init__(self, embedding_path: Optional[str] = None):
        self.embed_data: dict[int, np.ndarray] = {}
        self.path = Path(embedding_path) if embedding_path else None

    def add_block_data(self, block_ids, embeds,
                       allow_overwrite: bool = False) -> None:
        for bid, vec in zip(np.asarray(block_ids).tolist(),
                            np.asarray(embeds)):
            if not allow_overwrite and int(bid) in self.embed_data:
                raise ValueError(f"duplicate block id {bid}")
            self.embed_data[int(bid)] = np.asarray(vec)

    def clear(self) -> None:
        self.embed_data = {}

    def _shard_file(self, rank: int) -> Path:
        assert self.path is not None, "embedding_path not set"
        return self.path.with_suffix(f".shard{rank}.npz")

    def save_shard(self, rank: int = 0) -> Path:
        f = self._shard_file(rank)
        f.parent.mkdir(parents=True, exist_ok=True)
        ids = np.asarray(sorted(self.embed_data), np.int64)
        vecs = np.stack([self.embed_data[int(i)] for i in ids]) if len(ids) \
            else np.zeros((0, 0), np.float32)
        np.savez(f, ids=ids, vecs=vecs)
        return f

    def merge_shards_and_save(self) -> Path:
        """Rank 0's merge of every shard file into the final store
        (reference realm_index.py:86-116)."""
        assert self.path is not None
        merged: dict[int, np.ndarray] = {}
        shards = sorted(self.path.parent.glob(
            self.path.name + ".shard*.npz"))
        # with_suffix drops the extension: match both spellings
        shards += sorted(self.path.parent.glob(
            self.path.stem + ".shard*.npz"))
        for f in dict.fromkeys(shards):
            data = np.load(f)
            for bid, vec in zip(data["ids"], data["vecs"]):
                merged[int(bid)] = vec
        ids = np.asarray(sorted(merged), np.int64)
        vecs = np.stack([merged[int(i)] for i in ids])
        np.savez(self.path, ids=ids, vecs=vecs)
        self.embed_data = dict(zip(ids.tolist(), vecs))
        return self.path

    @classmethod
    def load(cls, embedding_path: str) -> "BlockDataStore":
        store = cls(embedding_path)
        data = np.load(store.path)
        store.embed_data = dict(zip(data["ids"].tolist(), data["vecs"]))
        return store

    def as_arrays(self):
        ids = np.asarray(sorted(self.embed_data), np.int64)
        vecs = np.stack([self.embed_data[int(i)] for i in ids])
        return ids, vecs


class IndexBuilder:
    """One epoch over the evidence dataset → ``BlockDataStore`` (reference
    IndexBuilder.build_and_save_index, indexer.py:72-123).

    ``dataset`` is ICTDataset-like: ``mapping`` rows (start, end, doc,
    block_id) and ``get_block(start, end, doc)`` → (tokens, pad_mask).
    The context tower runs on its parameters' device, without grad."""

    def __init__(self, cfg: ModelConfig, params, dataset,
                 embedding_path: Optional[str] = None,
                 batch_size: int = 32, log_interval: int = 100,
                 rank: int = 0, world: int = 1, pooling: str = "cls"):
        self.cfg = cfg
        self.params = params
        self.dataset = dataset
        self.batch_size = batch_size
        self.log_interval = log_interval
        self.rank, self.world = rank, world
        self.pooling = pooling
        self.store = BlockDataStore(embedding_path)
        self._proj_c = biencoder._context_proj(params)
        self._tower = biencoder.context_tower(params)

    def build(self) -> BlockDataStore:
        rows = np.asarray(self.dataset.mapping)[self.rank::self.world]
        # a multi-epoch mapping repeats each block under its block_id (ids
        # reset per epoch, reference helpers.cpp:527): index each once
        seen: set[int] = set()
        bs = self.batch_size
        iteration = 0
        total = 0
        for i in range(0, len(rows), bs):
            toks, masks, ids = [], [], []
            for start, end, doc, block_id in rows[i:i + bs]:
                if int(block_id) in seen:
                    continue
                seen.add(int(block_id))
                t, m = self.dataset.get_block(int(start), int(end), int(doc))
                toks.append(t)
                masks.append(m)
                ids.append(int(block_id))
            if not toks:
                continue
            embeds = biencoder.embed_batches(
                self.cfg, self._tower, np.stack(toks), np.stack(masks),
                self._proj_c, bs, self.pooling)
            self.store.add_block_data(ids, embeds)
            iteration += 1
            total += len(ids) * self.world
            if iteration % self.log_interval == 0:
                logger.info("indexer batch %d | ~total %d", iteration, total)
        return self.store

    def build_and_save_index(self) -> BlockDataStore:
        """build → save the shard → (rank 0) merge, the reference's
        save_shard / barrier / merge_shards_and_save sequence."""
        self.build()
        if self.store.path is None:
            return self.store
        self.store.save_shard(self.rank)
        if self.world > 1:
            # merging before every process wrote its shard would make a
            # partial index: a failed barrier must raise
            torch.distributed.barrier()
        if self.rank == 0:
            self.store.merge_shards_and_save()
        return self.store


def mips_search(block_vecs: np.ndarray, query_vecs: np.ndarray,
                top_k: int, device="cpu"):
    """Exact maximum-inner-product search → ``(index [q, k], scores [q,
    k])``, the fp32 product on ``device`` (the host by default)."""
    q = torch.as_tensor(np.asarray(query_vecs, np.float32), device=device)
    blocks = torch.as_tensor(np.asarray(block_vecs, np.float32),
                             device=device)
    scores = (q @ blocks.T).cpu().numpy()
    top_k = min(top_k, scores.shape[-1])
    if top_k < scores.shape[-1]:
        # O(N) partition, then sort the k winners alone
        part = np.argpartition(-scores, top_k - 1, axis=-1)[:, :top_k]
    else:
        part = np.broadcast_to(np.arange(top_k), scores.shape).copy()
    part_scores = np.take_along_axis(scores, part, axis=-1)
    order = np.argsort(-part_scores, axis=-1)
    idx = np.take_along_axis(part, order, axis=-1)
    return idx, np.take_along_axis(part_scores, order, axis=-1)
