"""T5 span-corruption dataset (a copy of
``megatron_llm_tpu/data/t5_dataset.py``: numpy alone, over the port's
``index_helpers`` and ``indexed_dataset``, so every sample is the JAX
package's byte for byte).

Reference parity: megatron/data/t5_dataset.py — masked spans replaced by
sentinel tokens, decoder reconstructs ``<sentinel_i> span_i ...``.  The
corpus is the same sentence-per-item indexed format as the BERT dataset;
samples pack consecutive sentences of a document up to the encoder length.

Layout (t5_dataset.py build_training_sample / pad_and_convert_to_numpy):
  encoder:  tokens with each noise span collapsed to one sentinel
  decoder:  [bos] s0 span0 s1 span1 ...
  labels:   s0 span0 s1 span1 ... [eos]
Sentinels are the *last* ``max_sentinels`` vocab ids, counting down, like
T5's extra_ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .index_helpers import build_bert_mapping
from .indexed_dataset import MMapIndexedDataset


@dataclass(frozen=True)
class T5SpecialTokens:
    bos: int
    eos: int
    pad: int


class T5Dataset:
    def __init__(self, indexed: MMapIndexedDataset, enc_seq_length: int,
                 dec_seq_length: int, vocab_size: int,
                 special: T5SpecialTokens,
                 masked_lm_prob: float = 0.15, mean_span_length: int = 3,
                 max_sentinels: int = 100, num_epochs: int = 1,
                 seed: int = 0, sentinel_ids=None):
        self.ds = indexed
        self.enc_len = enc_seq_length
        self.dec_len = dec_seq_length
        self.vocab_size = vocab_size
        self.special = special
        self.masked_lm_prob = masked_lm_prob
        self.mean_span = mean_span_length
        self.max_sentinels = max_sentinels
        self.seed = seed
        # Explicit sentinel ids (e.g. a real tokenizer's <extra_id_i>
        # additional_special_tokens) — without them the *last* vocab ids
        # are assumed, which can collide with live vocab on real
        # tokenizers.
        self.sentinel_ids = (None if sentinel_ids is None
                             else [int(s) for s in sentinel_ids])
        if self.sentinel_ids is not None:
            self.max_sentinels = min(self.max_sentinels,
                                     len(self.sentinel_ids))
        self.mapping = build_bert_mapping(
            np.asarray(indexed.sizes), np.asarray(indexed.doc_idx),
            max_num_tokens=enc_seq_length, short_seq_prob=0.0,
            num_epochs=num_epochs, seed=seed)

    def __len__(self) -> int:
        return len(self.mapping)

    def sentinel(self, i: int) -> int:
        if self.sentinel_ids is not None:
            return self.sentinel_ids[i]
        return self.vocab_size - 1 - i

    def __getitem__(self, idx: int) -> dict:
        start, end, target_len = (int(x) for x in self.mapping[idx])
        rng = np.random.default_rng((self.seed + 1) * 31415 + idx)
        tokens = np.concatenate(
            [np.asarray(self.ds[i]) for i in range(start, end)])[:target_len]
        n = len(tokens)

        # sample non-adjacent noise spans covering ~masked_lm_prob of tokens
        n_noise = max(1, int(round(n * self.masked_lm_prob)))
        spans = []
        covered = np.zeros(n, bool)
        budget = n_noise
        tries = 0
        while budget > 0 and tries < 4 * n and len(spans) < self.max_sentinels:
            tries += 1
            length = min(budget, max(1, int(rng.poisson(self.mean_span))))
            if n - length <= 0:
                break
            pos = int(rng.integers(0, n - length))
            # keep one unmasked token between spans so sentinels don't merge
            lo, hi = max(0, pos - 1), min(n, pos + length + 1)
            if covered[lo:hi].any():
                continue
            covered[pos:pos + length] = True
            spans.append((pos, length))
            budget -= length
        spans.sort()

        sp = self.special
        enc, dec, labels = [], [sp.bos], []
        cursor = 0
        for i, (pos, length) in enumerate(spans):
            s = self.sentinel(i)
            enc.extend(tokens[cursor:pos].tolist())
            enc.append(s)
            dec.append(s)
            dec.extend(tokens[pos:pos + length].tolist())
            labels.append(s)
            labels.extend(tokens[pos:pos + length].tolist())
            cursor = pos + length
        enc.extend(tokens[cursor:].tolist())
        labels.append(sp.eos)

        enc = enc[: self.enc_len]
        dec = dec[: self.dec_len]
        labels = labels[: self.dec_len]

        def pad_to(x, size, value):
            return np.concatenate(
                [np.asarray(x, np.int64), np.full(size - len(x), value)])

        return {
            "enc_tokens": pad_to(enc, self.enc_len, sp.pad),
            "enc_pad_mask": pad_to([1.0] * len(enc), self.enc_len, 0.0
                                   ).astype(np.float32),
            "dec_tokens": pad_to(dec, self.dec_len, sp.pad),
            "dec_pad_mask": pad_to([1.0] * len(dec), self.dec_len, 0.0
                                   ).astype(np.float32),
            "labels": pad_to(labels, self.dec_len, sp.pad),
            "loss_mask": pad_to([1.0] * len(labels), self.dec_len, 0.0
                                ).astype(np.float32),
        }
