"""Inverse-Cloze-Task dataset for bi-encoder pretraining (a copy of
``megatron_llm_tpu/data/ict_dataset.py``: numpy alone, over the port's
``index_helpers`` and ``indexed_dataset``, so every sample is the JAX
package's byte for byte).

Reference parity: megatron/data/ict_dataset.py — a (query, block) pair per
sample: the query is one sentence of a block and the context is the block
with that sentence removed with probability ``remove_prob`` (the reference's
``query_in_block_prob`` complement, ict_dataset.py:79-126).  Blocks come
from the exact ``build_blocks_mapping`` packing (helpers.cpp:454-694):
per-document targets shortened by the title length, long-sentence documents
rejected, rows carrying (start, end, doc, block_id) so the REALM indexer
(models/realm_indexer.py) can address evidence blocks by id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .index_helpers import build_blocks_mapping
from .indexed_dataset import MMapIndexedDataset


@dataclass(frozen=True)
class ICTSpecialTokens:
    cls: int
    sep: int
    pad: int


class ICTDataset:
    """ICT samples over sentence-per-item corpora.

    ``titles``: optional second indexed dataset with one title per
    *document* (the reference's --titles_data_path); when given, block
    targets shrink by the title length and context blocks are packed as
    [CLS] title [SEP] block [SEP] (reference concat_and_pad_tokens).
    """

    def __init__(self, indexed: MMapIndexedDataset, query_seq_length: int,
                 block_seq_length: int, special: ICTSpecialTokens,
                 remove_prob: float = 0.9, num_epochs: int = 1,
                 seed: int = 0, titles: Optional[MMapIndexedDataset] = None,
                 use_one_sent_blocks: bool = False):
        self.ds = indexed
        self.titles = titles
        self.q_len = query_seq_length
        self.b_len = block_seq_length
        self.special = special
        self.remove_prob = remove_prob
        self.seed = seed
        num_docs = len(indexed.doc_idx) - 1
        if titles is not None:
            title_sizes = np.asarray(titles.sizes, np.int32)[:num_docs]
        else:
            title_sizes = np.zeros(num_docs, np.int32)
        # reference target: max_seq_length - title_size; the [CLS]/[SEP]
        # overhead is carried in the max_seq_length we pass, like the
        # reference's 3 + len(title) pad offset
        overhead = 3 if titles is not None else 2
        self.mapping = build_blocks_mapping(
            np.asarray(indexed.doc_idx), np.asarray(indexed.sizes),
            title_sizes, num_epochs=num_epochs,
            max_seq_length=block_seq_length - overhead,
            use_one_sent_blocks=use_one_sent_blocks, seed=seed)

    def __len__(self) -> int:
        return len(self.mapping)

    def _pack(self, token_lists, seq_len, title=None):
        sp = self.special
        toks = [sp.cls]
        if title is not None:
            toks.extend(int(x) for x in title)
            toks.append(sp.sep)
        for t in token_lists:
            toks.extend(int(x) for x in t)
        toks = toks[: seq_len - 1] + [sp.sep]
        n = len(toks)
        pad = seq_len - n
        return (np.asarray(toks + [sp.pad] * pad, np.int64),
                np.asarray([1.0] * n + [0.0] * pad, np.float32))

    def get_block(self, start: int, end: int, doc: int):
        """Evidence block (+title) tokens for the REALM indexer
        (reference ict_dataset.py:get_block)."""
        sents = [np.asarray(self.ds[i]) for i in range(start, end)]
        title = (np.asarray(self.titles[doc])
                 if self.titles is not None else None)
        return self._pack(sents, self.b_len, title)

    def __getitem__(self, idx: int) -> dict:
        start, end, doc, block_id = (int(x) for x in self.mapping[idx])
        rng = np.random.default_rng((self.seed + 1) * 1618 + idx)
        sents = [np.asarray(self.ds[i]) for i in range(start, end)]
        qi = int(rng.integers(0, len(sents)))
        query = sents[qi]
        if len(sents) > 1 and rng.random() < self.remove_prob:
            block = sents[:qi] + sents[qi + 1:]
        else:
            block = sents
        title = (np.asarray(self.titles[doc])
                 if self.titles is not None else None)
        q_toks, q_mask = self._pack([query], self.q_len)
        c_toks, c_mask = self._pack(block, self.b_len, title)
        return {
            "query_tokens": q_toks,
            "query_pad_mask": q_mask,
            "context_tokens": c_toks,
            "context_pad_mask": c_mask,
            # (start, end, doc, block_id) — the indexer keys evidence
            # embeddings by block_id (reference realm_dataset_utils)
            "block_data": np.asarray([start, end, doc, block_id], np.int64),
        }
