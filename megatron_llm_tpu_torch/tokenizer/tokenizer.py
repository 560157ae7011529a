"""Tokenizer dispatch with vocab padding (mirror of
``megatron_llm_tpu/tokenizer/tokenizer.py``).

Parity with the reference (megatron/tokenizer/tokenizer.py:12-497):
``build_tokenizer`` dispatches on type — SentencePiece (Llama),
HF AutoTokenizer wrap (Falcon), GPT-2 BPE.  Vocab padding to a multiple of
``make_vocab_size_divisible_by × tp`` lives in
``ModelConfig.padded_vocab_size`` (config.py).  SentencePiece loads via
the `sentencepiece` package when present, else through HF's
LlamaTokenizer(Fast) which reads the same .model files; special
ChatML-style tokens can be appended via ``vocab_extra_ids_list`` (:326-497).

The native GPT-2 BPE and WordPiece tokenizers need nothing beyond the
standard library and numpy.  ``HFTokenizer`` needs ``transformers`` and
``SentencePieceTokenizer`` needs ``sentencepiece`` (or ``transformers``,
whose LlamaTokenizerFast reads the same .model files); each constructor
imports its package and raises ``ImportError`` naming it when it is
missing.
"""

from __future__ import annotations

import abc
import re
from typing import Optional, Sequence


class Tokenizer(abc.ABC):
    """Minimal interface the pipeline needs (reference AbstractTokenizer)."""

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


class HFTokenizer(Tokenizer):
    """Wrap any HF tokenizer (reference _FalconTokenizer pattern,
    tokenizer.py:288-323)."""

    def __init__(self, name_or_path: str,
                 vocab_extra_ids_list: Optional[Sequence[str]] = None):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                "HFTokenizer needs the 'transformers' package, which is "
                "not installed; the native tokenizers (gpt2-bpe, "
                "bert-wordpiece) need no package") from e

        self._t = AutoTokenizer.from_pretrained(name_or_path)
        if vocab_extra_ids_list:
            self._t.add_special_tokens(
                {"additional_special_tokens": list(vocab_extra_ids_list)})

    @property
    def inner(self):
        return self._t

    @property
    def vocab_size(self) -> int:
        return len(self._t)

    def tokenize(self, text: str) -> list[int]:
        return self._t.encode(text, add_special_tokens=False)

    def detokenize(self, ids) -> str:
        return self._t.decode(ids)

    @property
    def eod(self) -> int:
        t = self._t
        if t.eos_token_id is not None:
            return t.eos_token_id
        return t.pad_token_id or 0

    @property
    def bos(self):
        return self._t.bos_token_id

    @property
    def pad(self) -> int:
        if self._t.pad_token_id is not None:
            return self._t.pad_token_id
        return self.eod


class GPT2BPENativeTokenizer(Tokenizer):
    """Native vocab.json + merges.txt byte-level BPE (reference
    _GPT2BPETokenizer over gpt2_tokenization.py — no ``transformers``
    dependency).  ``path`` is a directory containing both files, or
    ``vocab.json,merges.txt``."""

    def __init__(self, path: str):
        import os

        from .bpe import GPT2BPETokenizer

        if "," in path:
            vocab_file, merges_file = path.split(",", 1)
        else:
            vocab_file = os.path.join(path, "vocab.json")
            merges_file = os.path.join(path, "merges.txt")
        self._t = GPT2BPETokenizer(vocab_file, merges_file)

    @property
    def vocab_size(self) -> int:
        return self._t.vocab_size

    def tokenize(self, text: str) -> list[int]:
        return self._t.encode(text)

    def detokenize(self, ids) -> str:
        return self._t.decode(ids)

    @property
    def eod(self) -> int:
        enc = self._t.encoder
        if "<|endoftext|>" in enc:
            return enc["<|endoftext|>"]
        return self.vocab_size - 1

    @property
    def pad(self) -> int:
        return self.eod


class WordPieceNativeTokenizer(Tokenizer):
    """Native vocab.txt WordPiece (reference _BertWordPieceTokenizer over
    bert_tokenization.py).  Exposes cls/sep/mask for the BERT/ICT data
    pipelines."""

    def __init__(self, vocab_file: str, lower_case: bool = True):
        from .bpe import WordPieceTokenizer

        self._t = WordPieceTokenizer(vocab_file, lower_case=lower_case)

    @property
    def vocab_size(self) -> int:
        return self._t.vocab_size

    def tokenize(self, text: str) -> list[int]:
        return self._t.encode(text)

    def detokenize(self, ids) -> str:
        return self._t.decode(ids)

    def _id(self, token: str) -> int:
        return self._t.vocab[token]

    @property
    def cls(self) -> int:
        return self._id("[CLS]")

    @property
    def sep(self) -> int:
        return self._id("[SEP]")

    @property
    def mask(self) -> int:
        return self._id("[MASK]")

    @property
    def pad(self) -> int:
        return self._id("[PAD]")

    @property
    def eod(self) -> int:
        return self.sep


class SentencePieceTokenizer(Tokenizer):
    """Llama .model tokenizer (reference _SentencePieceTokenizer,
    tokenizer.py:326-497)."""

    def __init__(self, model_file: str,
                 vocab_extra_ids_list: Optional[Sequence[str]] = None):
        try:
            import sentencepiece

            self._sp = sentencepiece.SentencePieceProcessor(
                model_file=model_file)
            self._hf = None
        except ImportError:
            try:
                from transformers import LlamaTokenizerFast
            except ImportError as e:
                raise ImportError(
                    "SentencePieceTokenizer needs the 'sentencepiece' "
                    "package (or 'transformers'), and neither is "
                    "installed") from e
            self._hf = LlamaTokenizerFast(vocab_file=model_file)
            self._sp = None
        self._extra: dict[str, int] = {}
        base = self.base_vocab_size
        for i, tok in enumerate(vocab_extra_ids_list or []):
            self._extra[tok] = base + i
        self._extra_by_id = {v: k for k, v in self._extra.items()}
        # Longest-first alternation so a special token that prefixes
        # another never shadows it.
        ordered = sorted(self._extra, key=len, reverse=True)
        self._extra_re = (
            re.compile("(" + "|".join(map(re.escape, ordered)) + ")")
            if self._extra else None
        )

    @property
    def base_vocab_size(self) -> int:
        if self._sp is not None:
            return self._sp.vocab_size()
        return len(self._hf)

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size + len(self._extra)

    def _encode_plain(self, text: str) -> list[int]:
        if self._sp is not None:
            return self._sp.encode(text)
        return self._hf.encode(text, add_special_tokens=False)

    def _decode_plain(self, ids: list[int]) -> str:
        if self._sp is not None:
            return self._sp.decode(ids)
        return self._hf.decode(ids)

    def tokenize(self, text: str) -> list[int]:
        """Split on registered special tokens, each emitted as its reserved
        id (reference _SentencePieceTokenizer.tokenize splits the text on
        special tokens the same way, tokenizer.py:418-441)."""
        if self._extra_re is None:
            return self._encode_plain(text)
        out: list[int] = []
        for part in self._extra_re.split(text):
            if not part:
                continue
            if part in self._extra:
                out.append(self._extra[part])
            else:
                out.extend(self._encode_plain(part))
        return out

    def detokenize(self, ids) -> str:
        pieces: list[str] = []
        run: list[int] = []
        for i in ids:
            if i in self._extra_by_id:
                if run:
                    pieces.append(self._decode_plain(run))
                    run = []
                pieces.append(self._extra_by_id[i])
            elif i < self.base_vocab_size:
                run.append(int(i))
        if run:
            pieces.append(self._decode_plain(run))
        return "".join(pieces)

    @property
    def eod(self) -> int:
        if self._sp is not None:
            return self._sp.eos_id()
        return self._hf.eos_token_id

    @property
    def bos(self):
        if self._sp is not None:
            return self._sp.bos_id()
        return self._hf.bos_token_id


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


def build_tokenizer(tokenizer_type: str, tokenizer_model: Optional[str] = None,
                    vocab_extra_ids_list: Optional[Sequence[str]] = None,
                    vocab_size: int = 256) -> Tokenizer:
    """Dispatch (reference tokenizer.py:12-37)."""
    t = tokenizer_type.lower()
    if t in ("sentencepiece", "sentencepiecetokenizer", "llama"):
        assert tokenizer_model, "SentencePiece tokenizer needs a model file"
        return SentencePieceTokenizer(tokenizer_model, vocab_extra_ids_list)
    if t in ("falcon", "hf", "huggingface", "falcontokenizer"):
        assert tokenizer_model, "HF tokenizer needs a name or path"
        return HFTokenizer(tokenizer_model, vocab_extra_ids_list)
    if t in ("gpt2", "gpt2bpetokenizer"):
        return HFTokenizer(tokenizer_model or "gpt2")
    if t in ("gpt2-bpe", "gpt2bpe"):
        assert tokenizer_model, ("native GPT-2 BPE needs a dir with "
                                 "vocab.json+merges.txt (or 'vocab,merges')")
        return GPT2BPENativeTokenizer(tokenizer_model)
    if t in ("bert-wordpiece", "wordpiece", "bertwordpiecelowercase"):
        assert tokenizer_model, "WordPiece needs a vocab.txt path"
        return WordPieceNativeTokenizer(tokenizer_model)
    if t in ("bertwordpiececase",):
        assert tokenizer_model, "WordPiece needs a vocab.txt path"
        return WordPieceNativeTokenizer(tokenizer_model, lower_case=False)
    if t in ("null", "nulltokenizer"):
        return NullTokenizer(vocab_size)
    raise ValueError(f"unknown tokenizer type {tokenizer_type!r}")
