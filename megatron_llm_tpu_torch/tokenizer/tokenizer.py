"""Tokenizer interface and the integer-passthrough ``NullTokenizer``: a
copy of the part of ``megatron_llm_tpu/tokenizer/tokenizer.py`` the
serving path needs (the port imports nothing of the JAX package).  The
SentencePiece / HF / BPE tokenizers come with the data slices."""

from __future__ import annotations

import abc
from typing import Optional, Sequence


class Tokenizer(abc.ABC):
    """Minimal interface the pipeline needs."""

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @abc.abstractmethod
    def tokenize(self, text: str) -> list[int]: ...

    @abc.abstractmethod
    def detokenize(self, ids: Sequence[int]) -> str: ...

    @property
    def eod(self) -> int:
        raise NotImplementedError

    @property
    def pad(self) -> int:
        return 0

    @property
    def bos(self) -> Optional[int]:
        return None


class NullTokenizer(Tokenizer):
    """Integer passthrough for tests / pre-tokenized corpora."""

    def __init__(self, vocab_size: int = 256):
        self._n = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._n

    def tokenize(self, text: str) -> list[int]:
        return [int(t) % self._n for t in text.split()]

    def detokenize(self, ids) -> str:
        return " ".join(str(i) for i in ids)

    @property
    def eod(self) -> int:
        return self._n - 1
