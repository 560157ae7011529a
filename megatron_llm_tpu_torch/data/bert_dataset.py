"""BERT pretraining dataset: sentence-pair (NSP) + masked-LM samples (a copy of
``megatron_llm_tpu/data/bert_dataset.py``: numpy alone, over the port's
``index_helpers`` and ``indexed_dataset``, so every sample is the JAX
package's byte for byte).

Reference parity: megatron/data/bert_dataset.py (build_training_sample,
pad_and_convert_to_numpy) over the mapping built by the native helper
(megatron/data/helpers.cpp build_mapping → our
index_helpers.build_bert_mapping).  The corpus is an indexed dataset whose
*items* are sentences and whose document boundaries group them (preprocess
with one sentence per add_item).

Each sample: [CLS] A [SEP] B [SEP] with tokentype 0/1, 50% of pairs having a
random-order B (``is_random`` label for the binary head), and 15% of tokens
masked for MLM (80% → [MASK], 10% → random, 10% → kept).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index_helpers import build_bert_mapping
from .indexed_dataset import MMapIndexedDataset


@dataclass(frozen=True)
class BertSpecialTokens:
    cls: int
    sep: int
    mask: int
    pad: int


class BertDataset:
    def __init__(self, indexed: MMapIndexedDataset, seq_length: int,
                 vocab_size: int, special: BertSpecialTokens,
                 masked_lm_prob: float = 0.15, short_seq_prob: float = 0.1,
                 num_epochs: int = 1, seed: int = 0):
        self.ds = indexed
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.special = special
        self.masked_lm_prob = masked_lm_prob
        self.seed = seed
        # 3 specials: [CLS] .. [SEP] .. [SEP]
        self.mapping = build_bert_mapping(
            np.asarray(indexed.sizes), np.asarray(indexed.doc_idx),
            max_num_tokens=seq_length - 3, short_seq_prob=short_seq_prob,
            num_epochs=num_epochs, seed=seed)

    def __len__(self) -> int:
        return len(self.mapping)

    def __getitem__(self, idx: int) -> dict:
        start, end, target_len = (int(x) for x in self.mapping[idx])
        rng = np.random.default_rng((self.seed + 1) * 2718 + idx)
        sents = [np.asarray(self.ds[i]) for i in range(start, end)]

        # A/B split on a sentence boundary (bert_dataset.py:94-110)
        split = int(rng.integers(1, len(sents)))
        a = np.concatenate(sents[:split])
        b = np.concatenate(sents[split:])
        is_random = int(rng.random() < 0.5)
        if is_random:
            a, b = b, a

        # truncate to target, trimming the longer side front/back randomly
        # (bert_dataset truncate_segments semantics)
        a, b = list(a), list(b)
        while len(a) + len(b) > target_len:
            side = a if len(a) > len(b) else b
            if rng.random() < 0.5:
                side.pop(0)
            else:
                side.pop()

        sp = self.special
        tokens = [sp.cls] + a + [sp.sep] + b + [sp.sep]
        tokentypes = [0] * (len(a) + 2) + [1] * (len(b) + 1)

        # MLM masking over non-special positions
        tokens = np.asarray(tokens, np.int64)
        labels = tokens.copy()
        maskable = np.ones(len(tokens), bool)
        maskable[0] = False
        maskable[len(a) + 1] = False
        maskable[-1] = False
        n_pred = max(1, int(round(maskable.sum() * self.masked_lm_prob)))
        cand = np.flatnonzero(maskable)
        picked = rng.choice(cand, size=min(n_pred, len(cand)), replace=False)
        loss_mask = np.zeros(len(tokens), np.float32)
        loss_mask[picked] = 1.0
        roll = rng.random(len(picked))
        for pos, r in zip(picked, roll):
            if r < 0.8:
                tokens[pos] = sp.mask
            elif r < 0.9:
                tokens[pos] = rng.integers(0, self.vocab_size)
            # else: keep the original token

        # pad to seq_length
        n = len(tokens)
        pad = self.seq_length - n
        out = {
            "tokens": np.concatenate([tokens, np.full(pad, sp.pad)]),
            "labels": np.concatenate([labels, np.full(pad, -1)]),
            "loss_mask": np.concatenate([loss_mask, np.zeros(pad, np.float32)]),
            "pad_mask": np.concatenate([np.ones(n, np.float32),
                                        np.zeros(pad, np.float32)]),
            "tokentype_ids": np.concatenate(
                [np.asarray(tokentypes, np.int64), np.zeros(pad, np.int64)]),
            "is_random": np.int64(is_random),
        }
        # labels at unmasked positions are ignored via loss_mask; clamp the
        # -1 fillers so the CE gather stays in range
        out["labels"] = np.where(out["labels"] < 0, 0, out["labels"])
        return out
