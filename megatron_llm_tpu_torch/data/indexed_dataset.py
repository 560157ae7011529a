"""Memory-mapped token storage (mirror of
``megatron_llm_tpu/data/indexed_dataset.py``), byte-compatible with the reference's
``.bin``/``.idx`` MMap format so existing preprocessed corpora load directly.

Format (reference: megatron/data/indexed_dataset.py:341-447):
  .idx: b'MMIDIDX\\x00\\x00' | <Q version=1 | <B dtype code | <Q num seqs |
        <Q doc count | int32 sizes[n] | int64 pointers[n] (byte offsets) |
        int64 doc_idx[doc_count]
  .bin: raw little-endian token payload

Dtype codes match the reference table (indexed_dataset.py:93-103).
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path
from typing import Sequence

import numpy as np

_HDR_MAGIC = b"MMIDIDX\x00\x00"

DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def dtype_code(dtype) -> int:
    return DTYPE_CODES[np.dtype(dtype)]


def best_dtype(vocab_size: int):
    """uint16 when the vocab fits (reference behavior for <65500 vocabs)."""
    return np.uint16 if vocab_size < 65500 else np.int32


def index_file_path(prefix: str) -> str:
    return str(prefix) + ".idx"


def data_file_path(prefix: str) -> str:
    return str(prefix) + ".bin"


class MMapIndexedDataset:
    """Read-only view over a .bin/.idx pair."""

    def __init__(self, path_prefix: str):
        self._prefix = str(path_prefix)
        with open(index_file_path(self._prefix), "rb") as f:
            magic = f.read(9)
            assert magic == _HDR_MAGIC, (
                f"{self._prefix}.idx is not an MMap indexed dataset"
            )
            (version,) = struct.unpack("<Q", f.read(8))
            assert version == 1
            (code,) = struct.unpack("<B", f.read(1))
            self._dtype = np.dtype(DTYPES[code])
            (self._len,) = struct.unpack("<Q", f.read(8))
            (self._doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()

        idx_buf = np.memmap(index_file_path(self._prefix), mode="r", order="C")
        self._sizes = np.frombuffer(idx_buf, np.int32, self._len, offset)
        self._pointers = np.frombuffer(
            idx_buf, np.int64, self._len, offset + self._sizes.nbytes)
        self._doc_idx = np.frombuffer(
            idx_buf, np.int64, self._doc_count,
            offset + self._sizes.nbytes + self._pointers.nbytes)
        self._idx_buf = idx_buf
        if Path(data_file_path(self._prefix)).stat().st_size == 0:
            # empty corpus (0 documents) — keep a valid empty buffer rather
            # than letting np.memmap fail on the empty file
            self._data = np.empty(0, dtype=np.uint8)
        else:
            self._data = np.memmap(data_file_path(self._prefix), mode="r",
                                   order="C")

    def __len__(self) -> int:
        return self._len

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    @property
    def doc_idx(self) -> np.ndarray:
        return self._doc_idx

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self._len)
            assert step == 1
            return [self[i] for i in range(start, stop)]
        ptr = self._pointers[idx]
        size = self._sizes[idx]
        return np.frombuffer(self._data, self._dtype, size, ptr)

    def get(self, idx: int, offset: int = 0, length: int | None = None):
        """Partial read within document ``idx`` (reference MMapIndexedDataset
        .get, used by gpt_dataset.__getitem__ for doc-spanning samples)."""
        size = int(self._sizes[idx])
        if length is None:
            length = size - offset
        ptr = self._pointers[idx] + offset * self._dtype.itemsize
        return np.frombuffer(self._data, self._dtype, length, ptr)

    @staticmethod
    def exists(prefix: str) -> bool:
        return (Path(index_file_path(prefix)).exists()
                and Path(data_file_path(prefix)).exists())


class MMapIndexedDatasetBuilder:
    """Streaming writer producing reference-compatible .bin/.idx pairs
    (reference: indexed_dataset.py:545-585)."""

    def __init__(self, out_prefix: str, dtype=np.int32):
        self._prefix = str(out_prefix)
        self._dtype = np.dtype(dtype)
        self._bin = open(data_file_path(self._prefix), "wb")
        self._sizes: list[int] = []
        self._doc_idx: list[int] = [0]

    def add_item(self, tokens: Sequence[int] | np.ndarray):
        arr = np.asarray(tokens, dtype=self._dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self):
        self._doc_idx.append(len(self._sizes))

    def add_doc(self, tokens):
        self.add_item(tokens)
        self.end_document()

    def merge_file(self, other_prefix: str):
        """Append another dataset (reference builder.merge_file_)."""
        other = MMapIndexedDataset(other_prefix)
        assert other.dtype == self._dtype
        base = len(self._sizes)
        self._sizes.extend(int(s) for s in other.sizes)
        # skip the leading 0 in the other doc index
        self._doc_idx.extend(base + int(d) for d in other.doc_idx[1:])
        with open(data_file_path(other_prefix), "rb") as f:
            shutil.copyfileobj(f, self._bin)

    def finalize(self):
        self._bin.close()
        sizes = np.asarray(self._sizes, dtype=np.int32)
        pointers = np.zeros(len(sizes), dtype=np.int64)
        if len(sizes) > 1:
            np.cumsum(sizes[:-1] * self._dtype.itemsize, out=pointers[1:])
        doc_idx = np.asarray(self._doc_idx, dtype=np.int64)
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_HDR_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", dtype_code(self._dtype)))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(doc_idx.tobytes(order="C"))


def write_dataset(prefix: str, documents: Sequence[Sequence[int]],
                  dtype=np.int32):
    """Convenience one-shot writer (tests, small corpora)."""
    b = MMapIndexedDatasetBuilder(prefix, dtype)
    for doc in documents:
        b.add_doc(doc)
    b.finalize()
