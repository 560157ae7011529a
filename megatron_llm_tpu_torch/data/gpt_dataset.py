"""GPT pretraining dataset: epoch-replicated, shuffled, doc-spanning samples
over a memory-mapped token corpus (mirror of
``megatron_llm_tpu/data/gpt_dataset.py``: the same prefix, split, seed and
sample counts give the same index files and samples).

Behavioral parity with the reference (megatron/data/gpt_dataset.py:20-513):
- documents are split train/valid/test by contiguous ranges from a
  "969,30,1"-style weight string (dataset_utils.get_train_valid_test_split_)
- doc_idx / sample_idx / shuffle_idx are built once, cached as .npy files
  keyed by (name, num_samples, seq_length, seed) and memory-mapped after
- samples span document boundaries; adjacent samples share the boundary
  token (sample i's last label token is sample i+1's first input token)
- the last partial epoch is shuffled separately when it covers < 80% of a
  full epoch, so early training sees each document at most once more than
  the others
"""

from __future__ import annotations

import hashlib
import os
import uuid
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import index_helpers
from .indexed_dataset import MMapIndexedDataset


def get_train_valid_test_split(splits_string: str, size: int) -> list[int]:
    """'969,30,1' → cumulative document boundaries [0, a, b, size]."""
    splits = [float(s) for s in splits_string.split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    assert total > 0
    bounds = [0]
    for s in splits:
        bounds.append(bounds[-1] + int(round(s / total * size)))
    diff = bounds[-1] - size
    bounds[-1] = size
    assert all(b >= 0 for b in bounds), (bounds, diff)
    return bounds


class GPTDataset:
    def __init__(
        self,
        name: str,
        indexed: MMapIndexedDataset,
        documents: np.ndarray,  # document ids belonging to this split
        num_samples: int,
        seq_length: int,
        seed: int,
        cache_dir: Optional[str] = None,
    ):
        self.name = name
        self.indexed = indexed
        self.seq_length = seq_length
        assert np.min(documents) >= 0
        assert np.max(documents) < len(indexed.sizes)
        self.doc_idx, self.sample_idx, self.shuffle_idx = _build_index_mappings(
            name, indexed._prefix, documents, indexed.sizes, num_samples,
            seq_length, seed, cache_dir,
        )

    def __len__(self) -> int:
        # -1: sample_idx has num_samples+1 rows (fenceposts)
        return self.sample_idx.shape[0] - 1

    def __getitem__(self, idx: int) -> dict:
        idx = self.shuffle_idx[idx]
        doc_f, off_f = self.sample_idx[idx]
        doc_l, off_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            sample = self.indexed.get(
                self.doc_idx[doc_f], offset=off_f,
                length=off_l - off_f + 1)
        else:
            parts = [self.indexed.get(self.doc_idx[doc_f], offset=off_f)]
            for i in range(doc_f + 1, doc_l):
                parts.append(self.indexed.get(self.doc_idx[i]))
            parts.append(self.indexed.get(self.doc_idx[doc_l],
                                          length=off_l + 1))
            sample = np.concatenate(parts)
        assert sample.shape[0] == self.seq_length + 1, sample.shape
        return {"text": sample.astype(np.int64)}


def _cache_key(prefix, name, num_samples, seq_length, seed) -> str:
    # The corpus prefix participates in the key so two corpora sharing a
    # cache directory can never reuse each other's index files.
    h = hashlib.sha1(str(Path(prefix).resolve()).encode()).hexdigest()[:10]
    return f"{Path(prefix).name}_{h}_{name}_{num_samples}ns_{seq_length}sl_{seed}s"


def _build_index_mappings(
    name: str,
    prefix: str,
    documents: np.ndarray,
    sizes: np.ndarray,
    num_samples: int,
    seq_length: int,
    seed: int,
    cache_dir: Optional[str],
):
    """Reference algorithm gpt_dataset.py:272-374, including the
    separate-last-epoch policy and on-disk .npy caching."""
    tokens_per_epoch = int(np.sum(sizes[documents]))
    assert tokens_per_epoch > 1
    num_epochs = 1
    while num_epochs * tokens_per_epoch - 1 < num_samples * seq_length:
        num_epochs += 1

    if num_epochs == 1:
        separate_last_epoch = False
    else:
        samples_minus_one = (
            (num_epochs - 1) * tokens_per_epoch - 1) // seq_length
        last_epoch_samples = num_samples - samples_minus_one
        assert 0 <= last_epoch_samples, "last epoch number of samples negative"
        samples_per_epoch = (tokens_per_epoch - 1) // seq_length
        assert last_epoch_samples <= samples_per_epoch + 1
        separate_last_epoch = last_epoch_samples < 0.80 * samples_per_epoch

    base = Path(cache_dir) if cache_dir else Path(str(prefix)).parent
    tag = _cache_key(prefix, name, num_samples, seq_length, seed)
    doc_file = base / f"{tag}_doc_idx.npy"
    sample_file = base / f"{tag}_sample_idx.npy"
    shuffle_file = base / f"{tag}_shuffle_idx.npy"

    if not (doc_file.exists() and sample_file.exists()
            and shuffle_file.exists()):
        rng = np.random.RandomState(seed)
        doc_idx = _build_doc_idx(documents, num_epochs, rng,
                                 separate_last_epoch)
        sample_idx = index_helpers.build_sample_idx(
            sizes, doc_idx, seq_length, num_epochs, tokens_per_epoch)
        if separate_last_epoch:
            num_first = samples_minus_one
        else:
            num_first = sample_idx.shape[0] - 1
        shuffle_idx = _build_shuffle_idx(
            num_first, sample_idx.shape[0] - 1, rng)
        base.mkdir(parents=True, exist_ok=True)
        # Atomic publish (tmp + rename): concurrent builders on shared
        # storage may redo work but can never mmap a torn file (the
        # reference instead gates the build on rank 0 + barrier,
        # gpt_dataset.py:272-310).
        for f, arr in ((doc_file, doc_idx), (sample_file, sample_idx),
                       (shuffle_file, shuffle_idx)):
            tmp = f.with_suffix(f".tmp{os.getpid()}.{uuid.uuid4().hex}.npy")
            np.save(tmp, arr, allow_pickle=False)
            os.replace(tmp, f)

    doc_idx = np.load(doc_file, mmap_mode="r", allow_pickle=False)
    sample_idx = np.load(sample_file, mmap_mode="r", allow_pickle=False)
    shuffle_idx = np.load(shuffle_file, mmap_mode="r", allow_pickle=False)
    return doc_idx, sample_idx, shuffle_idx


def _build_doc_idx(documents, num_epochs, rng, separate_last_epoch):
    """Shuffled document order over all epochs (reference
    gpt_dataset.py:376-395)."""
    if not separate_last_epoch or num_epochs == 1:
        doc_idx = np.mgrid[0:num_epochs, 0:len(documents)][1]
        doc_idx[:] = documents
        doc_idx = doc_idx.reshape(-1).astype(np.int32)
        rng.shuffle(doc_idx)
        return doc_idx
    doc_idx_first = _build_doc_idx(documents, num_epochs - 1, rng, False)
    doc_idx_last = _build_doc_idx(documents, 1, rng, False)
    return np.concatenate((doc_idx_first, doc_idx_last))


def _build_shuffle_idx(num_first: int, total: int, rng) -> np.ndarray:
    """Permutation with the last partial epoch shuffled separately
    (reference gpt_dataset.py:398-418)."""
    dtype = np.int64 if total >= (np.iinfo(np.uint32).max - 1) else np.uint32
    first = np.arange(num_first, dtype=dtype)
    rng.shuffle(first)
    if num_first == total:
        return first
    last = np.arange(num_first, total, dtype=dtype)
    rng.shuffle(last)
    return np.concatenate((first, last))


def build_gpt_datasets(
    data_prefix: str,
    splits_string: str,
    train_valid_test_num_samples: Sequence[int],
    seq_length: int,
    seed: int,
    cache_dir: Optional[str] = None,
):
    """train/valid/test GPTDatasets from one corpus prefix
    (reference: gpt_dataset.py:94-141 _build_train_valid_test_datasets)."""
    indexed = MMapIndexedDataset(data_prefix)
    total_docs = indexed.sizes.shape[0]
    splits = get_train_valid_test_split(splits_string, total_docs)
    names = ["train", "valid", "test"]
    out = []
    for i, name in enumerate(names):
        if splits[i + 1] > splits[i] and train_valid_test_num_samples[i] > 0:
            documents = np.arange(splits[i], splits[i + 1], dtype=np.int32)
            out.append(GPTDataset(
                name, indexed, documents,
                train_valid_test_num_samples[i], seq_length, seed,
                cache_dir))
        else:
            out.append(None)
    return tuple(out)
