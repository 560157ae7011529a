"""ctypes bridge to the native index helpers, with their numpy twins
(mirror of ``megatron_llm_tpu/data/index_helpers.py``).

``csrc/index_helpers.cpp`` is built with ``g++`` by ``utils/native.py``
into ``build/native/``.  Every entry point takes ``native``: True (the
default) builds and calls the C++ helper and raises if it cannot be
built; False runs the numpy twin (``*_py``).  There is no silent
fallback: ``build_bert_mapping`` and ``build_blocks_mapping`` draw
different random streams on the two paths (``std::mt19937`` against
numpy's ``Generator``), so the mix of samples depends on which ran.
``build_sample_idx`` and ``build_blending_indices`` draw nothing: both
paths give the same arrays.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..utils.native import compile_and_load

_SRC = Path(__file__).parent / "csrc" / "index_helpers.cpp"

_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The native helper library, built on first use; raises
    ``utils.native.NativeBuildError`` when ``g++`` cannot build it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = compile_and_load(_SRC)
        lib.sample_idx_rows.restype = ctypes.c_int64
        lib.sample_idx_rows.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64]
        lib.build_sample_idx.restype = None
        lib.build_sample_idx.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.build_blending_indices.restype = None
        lib.build_blending_indices.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int64]
        lib.build_bert_mapping.restype = ctypes.c_int64
        lib.build_bert_mapping.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32)]
        lib.build_blocks_mapping.restype = ctypes.c_int64
        lib.build_blocks_mapping.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return lib


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# build_sample_idx
# ---------------------------------------------------------------------------


def build_sample_idx_py(sizes: np.ndarray, doc_idx: np.ndarray,
                        seq_length: int, num_epochs: int,
                        tokens_per_epoch: int) -> np.ndarray:
    """Pure-numpy fallback; same semantics as the native version."""
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), dtype=np.int32)
    doc_idx_index = 0
    doc_offset = 0
    out[0] = (doc_idx_index, doc_offset)
    for i in range(1, num_samples + 1):
        remaining = seq_length + 1
        while remaining != 0:
            doc_id = doc_idx[doc_idx_index]
            doc_length = int(sizes[doc_id]) - doc_offset
            remaining -= doc_length
            if remaining <= 0:
                doc_offset += remaining + doc_length - 1
                remaining = 0
            else:
                doc_idx_index += 1
                doc_offset = 0
        out[i] = (doc_idx_index, doc_offset)
    return out


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_epochs: int, tokens_per_epoch: int,
                     native: bool = True) -> np.ndarray:
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, dtype=np.int32)
    if not native:
        return build_sample_idx_py(sizes, doc_idx, seq_length, num_epochs,
                                   tokens_per_epoch)
    lib = get_lib()
    rows = lib.sample_idx_rows(seq_length, num_epochs, tokens_per_epoch)
    out = np.empty((rows, 2), dtype=np.int32)
    lib.build_sample_idx(
        _as_ptr(sizes, ctypes.c_int32), _as_ptr(doc_idx, ctypes.c_int32),
        seq_length, num_epochs, tokens_per_epoch,
        _as_ptr(out, ctypes.c_int32))
    return out


# ---------------------------------------------------------------------------
# build_blending_indices
# ---------------------------------------------------------------------------


def build_blending_indices_py(weights: np.ndarray, size: int):
    num = len(weights)
    dataset_index = np.zeros(size, dtype=np.uint8)
    dataset_sample_index = np.zeros(size, dtype=np.int64)
    current = np.zeros(num, dtype=np.int64)
    for s in range(size):
        s_d = max(float(s), 1.0)
        errors = weights * s_d - current
        best = int(np.argmax(errors))
        dataset_index[s] = best
        dataset_sample_index[s] = current[best]
        current[best] += 1
    return dataset_index, dataset_sample_index


def build_blending_indices(weights: np.ndarray, size: int,
                           native: bool = True):
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if not native:
        return build_blending_indices_py(weights, size)
    lib = get_lib()
    dataset_index = np.empty(size, dtype=np.uint8)
    dataset_sample_index = np.empty(size, dtype=np.int64)
    lib.build_blending_indices(
        _as_ptr(dataset_index, ctypes.c_uint8),
        _as_ptr(dataset_sample_index, ctypes.c_int64),
        _as_ptr(weights, ctypes.c_double), len(weights), size)
    return dataset_index, dataset_sample_index


# ---------------------------------------------------------------------------
# build_bert_mapping (reference helpers.cpp build_mapping)
# ---------------------------------------------------------------------------


def build_bert_mapping_py(sent_sizes: np.ndarray, doc_sent_idx: np.ndarray,
                          max_num_tokens: int, short_seq_prob: float,
                          num_epochs: int, seed: int) -> np.ndarray:
    """Numpy fallback: same packing algorithm, numpy PRNG (the native and
    fallback paths are each deterministic but draw different streams)."""
    rng = np.random.default_rng(seed)

    def target_len():
        if rng.random() < short_seq_prob:
            return int(rng.integers(2, max_num_tokens + 1))
        return max_num_tokens

    rows = []
    for _ in range(num_epochs):
        for doc in range(len(doc_sent_idx) - 1):
            first, last = int(doc_sent_idx[doc]), int(doc_sent_idx[doc + 1])
            if last - first < 2:
                continue
            target = target_len()
            start, length, num_sent = first, 0, 0
            for s in range(first, last):
                length += int(sent_sizes[s])
                num_sent += 1
                if num_sent >= 2 and (length >= target or s == last - 1):
                    rows.append((start, s + 1, target))
                    start, length, num_sent = s + 1, 0, 0
                    target = target_len()
    out = np.asarray(rows, dtype=np.int32).reshape(-1, 3)
    rng.shuffle(out, axis=0)
    return out


def build_bert_mapping(sent_sizes: np.ndarray, doc_sent_idx: np.ndarray,
                       max_num_tokens: int, short_seq_prob: float = 0.1,
                       num_epochs: int = 1, seed: int = 0,
                       native: bool = True) -> np.ndarray:
    """[rows, 3] of (first_sentence, one_past_last, target_len), shuffled."""
    sent_sizes = np.ascontiguousarray(sent_sizes, dtype=np.int32)
    doc_sent_idx = np.ascontiguousarray(doc_sent_idx, dtype=np.int64)
    if not native:
        return build_bert_mapping_py(sent_sizes, doc_sent_idx,
                                     max_num_tokens, short_seq_prob,
                                     num_epochs, seed)
    lib = get_lib()
    max_rows = num_epochs * len(sent_sizes)
    out = np.empty((max_rows, 3), dtype=np.int32)
    rows = lib.build_bert_mapping(
        _as_ptr(sent_sizes, ctypes.c_int32),
        _as_ptr(doc_sent_idx, ctypes.c_int64),
        len(doc_sent_idx) - 1, max_num_tokens,
        ctypes.c_double(short_seq_prob), num_epochs, seed,
        _as_ptr(out, ctypes.c_int32))
    return out[:rows].copy()


# ---------------------------------------------------------------------------
# build_blocks_mapping (ICT/REALM blocks; reference helpers.cpp:454-694)
# ---------------------------------------------------------------------------


def build_blocks_mapping_py(doc_sent_idx: np.ndarray,
                            sent_sizes: np.ndarray,
                            title_sizes: np.ndarray,
                            num_epochs: int, max_num_samples: int,
                            max_seq_length: int,
                            long_sentence_len: int = 512,
                            use_one_sent_blocks: bool = False,
                            seed: int = 0) -> np.ndarray:
    """Pure-numpy fallback; same packing semantics as the native version
    (different shuffle RNG stream — numpy Generator vs mt19937_64)."""
    min_num_sent = 1 if use_one_sent_blocks else 2
    rows = []
    for epoch in range(num_epochs):
        block_id = 0
        if len(rows) >= max_num_samples:
            break
        for doc in range(len(doc_sent_idx) - 1):
            first = int(doc_sent_idx[doc])
            last = int(doc_sent_idx[doc + 1])
            target = max_seq_length - int(title_sizes[doc])
            n_remain = last - first
            if n_remain < min_num_sent:
                continue
            if np.any(sent_sizes[first:last] > long_sentence_len):
                continue
            start, seq_len, num_sent = first, 0, 0
            for s in range(first, last):
                seq_len += int(sent_sizes[s])
                num_sent += 1
                n_remain -= 1
                if ((seq_len >= target and n_remain >= min_num_sent
                     and num_sent >= min_num_sent) or n_remain == 0):
                    rows.append((start, s + 1, doc, block_id))
                    block_id += 1
                    start, seq_len, num_sent = s + 1, 0, 0
    out = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    np.random.default_rng(seed + 1).shuffle(out, axis=0)
    return out


def build_blocks_mapping(doc_sent_idx: np.ndarray, sent_sizes: np.ndarray,
                         title_sizes: np.ndarray, num_epochs: int = 1,
                         max_num_samples: int = 2**62,
                         max_seq_length: int = 512,
                         long_sentence_len: int = 512,
                         use_one_sent_blocks: bool = False,
                         seed: int = 0, native: bool = True) -> np.ndarray:
    """[rows, 4] of (first_sentence, one_past_last, doc, block_id),
    shuffled — the reference's exact ICT/REALM block packing including
    per-document title-length targets and long-sentence document rejection
    (helpers.cpp:454-694)."""
    doc_sent_idx = np.ascontiguousarray(doc_sent_idx, dtype=np.int64)
    sent_sizes = np.ascontiguousarray(sent_sizes, dtype=np.int32)
    title_sizes = np.ascontiguousarray(title_sizes, dtype=np.int32)
    num_docs = len(doc_sent_idx) - 1
    assert len(title_sizes) == num_docs, (len(title_sizes), num_docs)
    if not native:
        return build_blocks_mapping_py(
            doc_sent_idx, sent_sizes, title_sizes, num_epochs,
            max_num_samples, max_seq_length, long_sentence_len,
            use_one_sent_blocks, seed)
    lib = get_lib()
    args = [
        _as_ptr(doc_sent_idx, ctypes.c_int64), num_docs,
        _as_ptr(sent_sizes, ctypes.c_int32),
        _as_ptr(title_sizes, ctypes.c_int32),
        num_epochs, ctypes.c_int64(max_num_samples), max_seq_length,
        long_sentence_len, int(use_one_sent_blocks), seed,
    ]
    n = lib.build_blocks_mapping(*args, None)
    out = np.empty((n, 4), dtype=np.int32)
    lib.build_blocks_mapping(*args, _as_ptr(out, ctypes.c_int32))
    return out
