"""The safetensors file format, read and written with numpy and torch alone.

A file is a little-endian u64 header length ``n``, ``n`` bytes of JSON
(``{"__metadata__": {str: str}, name: {"dtype", "shape", "data_offsets"},
...}``, padded with spaces to a multiple of 8), then the tensors' raw
bytes.  The writer lays tensors out as the ``safetensors`` package does
(by dtype, widest first, then by name; compact JSON; sorted metadata), so
its files are byte for byte the package's.  A large tree is sharded into
``model-0000i-of-0000n.safetensors`` files beside a
``model.safetensors.index.json`` that maps each name to its file.

Host memory stays bounded by a 64 MiB piece.  The reader reads a leaf
straight into its tensor where that lies in host memory, and onto a card
in pieces through one pinned buffer.  (It does not map the file: where
a mapping's touched pages count against the process until it is
unmapped, as in some sandboxed kernels whatever ``madvise`` says, a map
holds the whole file resident.)  The writer takes any mapping: it
plans the header from each leaf's ``spec`` (shape and dtype on the
``meta`` device, where the mapping has a ``spec`` method), then asks for
one leaf at a time and moves it to the host in pieces of 64 MiB, so a
lazy mapping (an export that computes each leaf on access) is written
without a second copy of the tree anywhere.  BF16 has no numpy dtype, so
raw bytes are read as bytes into the typed tensor's storage.

``hf_state_dict`` opens a HuggingFace model directory (a safetensors file
or shards with their index, or ``pytorch_model.bin`` read with
``torch.load(weights_only=True, mmap=True)``) as a lazy mapping.  A
``.bin`` is mapped whole, and the pages a converter touches stay mapped
until the mapping is dropped.
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
for _name in ("U16", "U32", "U64"):
    if hasattr(torch, "uint" + _name[1:]):
        _DTYPES[_name] = getattr(torch, "uint" + _name[1:])
_NAMES = {v: k for k, v in _DTYPES.items()}
# the package's dtype order; a file lists the highest first, then by name
_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
          "F32", "F64", "I64", "U64")

SAFE_WEIGHTS = "model.safetensors"
_PIECE = 64 << 20  # bytes a writer moves to the host at once
SAFE_INDEX = "model.safetensors.index.json"
BIN_WEIGHTS = "pytorch_model.bin"
MAX_SHARD_BYTES = 5 * 10**9  # HF's default shard size (5 GB)


def read_header(path) -> tuple[dict, int]:
    """``(header dict, byte offset of the data)``; ``ValueError`` for a
    file too short for its header or its tensors."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, no header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes, file of {size}")
        header = json.loads(f.read(n))
    end = max((v["data_offsets"][1] for k, v in header.items()
               if k != "__metadata__"), default=0)
    if 8 + n + end > size:
        raise ValueError(f"{path}: tensors end at byte {8 + n + end}, the "
                         f"file at {size}")
    return header, 8 + n


def spec_of(tensors, name: str) -> torch.Tensor:
    """``tensors[name]``'s shape and dtype as a ``meta`` tensor, without
    computing or reading the leaf where the mapping offers ``spec``."""
    spec = getattr(tensors, "spec", None)
    return spec(name) if spec is not None else tensors[name]


def nbytes(tensors) -> int:
    """The bytes of every leaf of a mapping, from the specs."""
    return sum(t.numel() * t.element_size()
               for t in (spec_of(tensors, k) for k in tensors))


def _fill(f, dst: torch.Tensor) -> None:
    """Read the next ``dst.numel()`` bytes of ``f`` into the host uint8
    tensor ``dst``."""
    view = memoryview(dst.numpy())
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"{f.name}: the file ends inside a tensor")
        got += n


class SafeFile:
    """One safetensors file: ``keys()``, ``metadata()``, ``spec(name)``,
    and ``get(name, device, dtype)`` / ``read_into(name, out)`` read one
    tensor."""

    def __init__(self, path):
        self.path = str(path)
        self.header, self._start = read_header(path)
        self._meta = self.header.pop("__metadata__", None) or {}

    def keys(self):
        return list(self.header)

    def metadata(self) -> dict:
        return dict(self._meta)

    def spec(self, name: str) -> torch.Tensor:
        """``name``'s shape and dtype, from the header."""
        info = self.header[name]
        return torch.empty(info["shape"], dtype=_DTYPES[info["dtype"]],
                           device="meta")

    def _read(self, name: str, out: torch.Tensor) -> torch.Tensor:
        """``name``'s bytes into ``out`` (contiguous, the leaf's dtype and
        shape): straight into host memory, or through one pinned 64 MiB
        buffer onto a card."""
        lo, hi = (self._start + o for o in self.header[name]["data_offsets"])
        dst = out.reshape(-1).view(torch.uint8)
        if dst.numel() != hi - lo:
            raise ValueError(f"{self.path}: {name} holds {hi - lo} bytes, "
                             f"its tensor {dst.numel()}")
        if not dst.numel():
            return out
        with open(self.path, "rb", buffering=0) as f:
            f.seek(lo)
            if dst.device.type == "cpu":
                _fill(f, dst)
                return out
            buf = torch.empty(min(_PIECE, dst.numel()), dtype=torch.uint8,
                              pin_memory=True)
            for off in range(0, dst.numel(), _PIECE):
                piece = buf[:min(_PIECE, dst.numel() - off)]
                _fill(f, piece)
                dst[off:off + piece.numel()].copy_(piece)
        return out

    def get(self, name: str, device="cpu", dtype=None) -> torch.Tensor:
        """A new tensor on ``device`` (in ``dtype`` if given)."""
        spec = self.spec(name)
        t = self._read(name, torch.empty(spec.shape, dtype=spec.dtype,
                                         device=device))
        return t if dtype in (None, t.dtype) else t.to(dtype)

    def read_into(self, name: str, out: torch.Tensor) -> torch.Tensor:
        """Copy ``name`` into ``out`` (same shape; any device and dtype)."""
        if out.is_contiguous() and out.dtype == self.spec(name).dtype:
            return self._read(name, out)
        return out.copy_(self.get(name, out.device))


def load_file(path, device="cpu", dtype=None) -> Dict[str, torch.Tensor]:
    """Every tensor of one file on ``device`` (cast to ``dtype`` if
    given), in the file's order."""
    f = SafeFile(path)
    return {k: f.get(k, device, dtype) for k in f.keys()}


def _header_bytes(specs: Dict[str, torch.Tensor],
                  metadata: Optional[dict]) -> tuple[bytes, list]:
    for k, t in specs.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(specs, key=lambda k: (
        -_ORDER.index(_NAMES[specs[k].dtype]), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in sorted(metadata.items())}
    off = 0
    for k in order:
        t = specs[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw, order


def save_file(tensors: Mapping, path, metadata: Optional[dict] = None,
              fsync: bool = False) -> int:
    """Write ``tensors`` (a mapping of tensors on any device, or one that
    computes each on access) to ``path``; returns the bytes of tensor
    data written.  One leaf at a time is asked for, and it crosses to the
    host in pieces of 64 MiB.  With ``fsync`` the file is on disk when
    this returns (a checkpoint's commit needs that; an export does
    not)."""
    specs = {k: spec_of(tensors, k) for k in tensors}
    head, order = _header_bytes(specs, metadata)
    total = 0
    with open(path, "wb") as f:
        f.write(head)
        for k in order:
            if specs[k].numel() == 0:
                continue
            t = tensors[k].detach()
            if t.shape != specs[k].shape or t.dtype != specs[k].dtype:
                raise ValueError(f"{k}: {t.dtype} {tuple(t.shape)}, its "
                                 f"spec {specs[k].dtype} "
                                 f"{tuple(specs[k].shape)}")
            raw = t.reshape(-1).view(torch.uint8)
            del t
            for lo in range(0, raw.numel(), _PIECE):
                f.write(memoryview(raw[lo:lo + _PIECE].cpu().numpy()))
            total += raw.numel()
            del raw
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return total


class _Shard(Mapping):
    """Some keys of a mapping, read through to it (a lazy mapping stays
    lazy)."""

    def __init__(self, tensors: Mapping, keys: list):
        self._tensors, self._keys = tensors, keys

    def __getitem__(self, name):
        return self._tensors[name]

    def spec(self, name: str) -> torch.Tensor:
        return spec_of(self._tensors, name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def save_sharded(tensors: Mapping, directory,
                 max_shard_bytes: int = MAX_SHARD_BYTES,
                 fsync: bool = False) -> list[str]:
    """HF's layout: one ``model.safetensors``, or shards of at most
    ``max_shard_bytes`` (in insertion order; a larger single tensor gets a
    shard of its own) beside ``model.safetensors.index.json``.  The
    shards are planned from the specs and each leaf is asked for once,
    when its file is written.  Returns the file names written."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    shards: list[list] = [[]]
    size = 0
    for k in tensors:
        t = spec_of(tensors, k)
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(k)
        size += n
    meta = {"format": "pt"}
    if len(shards) == 1:
        save_file(_Shard(tensors, shards[0]), directory / SAFE_WEIGHTS,
                  meta, fsync)
        return [SAFE_WEIGHTS]
    names, weight_map, total = [], {}, 0
    for i, keys in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += save_file(_Shard(tensors, keys), directory / name, meta,
                           fsync)
        names.append(name)
        weight_map.update({k: name for k in keys})
    (directory / SAFE_INDEX).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return names


class LazyStateDict(Mapping):
    """A read-only mapping whose ``[name]`` reads one tensor from disk onto
    ``device``.  Nothing is cached, so a converter that drops each tensor
    after use holds one at a time."""

    def __init__(self, files: Dict[str, object], device="cpu"):
        self._files = files  # name -> SafeFile, or name -> loaded tensor
        self.device = device

    def file_of(self, name: str):
        """The ``SafeFile`` (or the loaded tensor) ``name`` comes from."""
        return self._files[name]

    def spec(self, name: str) -> torch.Tensor:
        src = self._files[name]
        if isinstance(src, SafeFile):
            return src.spec(name)
        return torch.empty(src.shape, dtype=src.dtype, device="meta")

    def __getitem__(self, name):
        src = self._files[name]
        if isinstance(src, SafeFile):
            return src.get(name, self.device)
        return src.to(device=self.device)

    def __iter__(self) -> Iterator[str]:
        return iter(self._files)

    def __len__(self) -> int:
        return len(self._files)


def open_sharded(directory, device="cpu") -> LazyStateDict:
    """A directory's ``model.safetensors``, or the shards its index names,
    as a lazy mapping."""
    directory = Path(directory)
    if (directory / SAFE_INDEX).exists():
        index = json.loads((directory / SAFE_INDEX).read_text())
        opened: Dict[str, SafeFile] = {}
        files = {}
        for k, fname in index["weight_map"].items():
            if fname not in opened:
                opened[fname] = SafeFile(directory / fname)
            files[k] = opened[fname]
        return LazyStateDict(files, device)
    f = SafeFile(directory / SAFE_WEIGHTS)
    return LazyStateDict({k: f for k in f.keys()}, device)


def hf_state_dict(directory, device="cpu") -> LazyStateDict:
    """The weights of an HF model directory as a lazy mapping: safetensors
    (one file or an index of shards) where present, else
    ``pytorch_model.bin``, memory-mapped."""
    directory = Path(directory)
    if (directory / SAFE_INDEX).exists() or (directory / SAFE_WEIGHTS).exists():
        return open_sharded(directory, device)
    if not (directory / BIN_WEIGHTS).exists():
        raise FileNotFoundError(f"no {SAFE_WEIGHTS}, {SAFE_INDEX} or "
                                f"{BIN_WEIGHTS} under {directory}")
    return LazyStateDict(torch.load(directory / BIN_WEIGHTS,
                                    map_location="cpu", weights_only=True,
                                    mmap=True), device)
