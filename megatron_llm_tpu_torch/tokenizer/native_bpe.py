"""ctypes bridge to the native BPE merge engine (mirror of
``megatron_llm_tpu/tokenizer/native_bpe.py``).

``csrc/bpe_encoder.cpp`` is built with ``g++`` by ``utils/native.py``
into ``build/native/``; ``get_lib`` raises when it cannot be built, and
``bpe.GPT2BPETokenizer(..., use_native=False)`` runs the Python merge loop
instead.  Both give the same ids.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from ..utils.native import compile_and_load

_SRC = Path(__file__).parent / "csrc" / "bpe_encoder.cpp"

_lock = threading.Lock()
_lib = None


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = compile_and_load(_SRC)
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_add_token.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32]
        lib.bpe_add_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        lib.bpe_encode_batch.restype = ctypes.c_int64
        lib.bpe_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _lib = lib
        return lib


class NativeBPE:
    """A loaded engine holding one vocabulary.  ``encode_pretokens`` maps
    byte-encoder-mapped pretoken strings → flat id list (the same result
    as running tokenizer/bpe.py's merge loop per token)."""

    def __init__(self, encoder: dict, ranks: dict):
        lib = get_lib()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.bpe_new())
        for tok, idx in encoder.items():
            b = tok.encode("utf-8")
            lib.bpe_add_token(self._h, b, len(b), int(idx))
        # insertion into the engine follows the rank VALUES (not dict
        # order): a duplicated merges.txt line reassigns the Python-side
        # rank, and the engine must agree with the Python loop exactly
        for (a, bb), _rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            ab, bbb = a.encode("utf-8"), bb.encode("utf-8")
            lib.bpe_add_merge(self._h, ab, len(ab), bbb, len(bbb))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.bpe_free(self._h)
        except Exception:
            pass

    def encode_pretokens(
        self, pretokens: Sequence[str],
    ) -> tuple[list[int], list[int]]:
        """→ (flat id list, per-token id offsets [len(pretokens)+1]).
        Returned as a tuple (not instance state) so concurrent encodes on
        a shared tokenizer can't read each other's boundaries."""
        if not pretokens:
            return [], [0]
        bufs = [t.encode("utf-8") for t in pretokens]
        offs = np.zeros(len(bufs) + 1, np.int64)
        np.cumsum([len(b) for b in bufs], out=offs[1:])
        flat = b"".join(bufs)
        cap = max(len(flat), 16)
        out_ids = np.empty(cap, np.int32)
        out_offs = np.empty(len(bufs) + 1, np.int64)
        n = self._lib.bpe_encode_batch(
            self._h, flat, offs.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            len(bufs),
            out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if n < 0:
            raise RuntimeError("native bpe batch failed (unknown symbol "
                               "or overflow)")
        return out_ids[:n].tolist(), out_offs.tolist()
