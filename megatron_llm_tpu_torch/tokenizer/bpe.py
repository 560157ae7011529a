"""Native byte-level BPE (GPT-2) and WordPiece (BERT) tokenizers (mirror of
``megatron_llm_tpu/tokenizer/bpe.py``).

Reference parity: megatron/tokenizer/gpt2_tokenization.py (vocab.json +
merges.txt byte-level BPE) and bert_tokenization.py (vocab.txt greedy
longest-match WordPiece), read from the vocabulary files without
``transformers``.  GPT-2's pretokenizer is a scanner over
``unicodedata.category`` (``gpt2_split``), so the port needs no
``regex`` module.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE
# ---------------------------------------------------------------------------


def bytes_to_unicode() -> dict:
    """The GPT-2 reversible byte→unicode table: printable latin bytes map
    to themselves, the rest to 256+offset code points, so every byte
    string has a lossless text form."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {}
    extra = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


# GPT-2's pretokenizer, the published pattern
#   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# as a scanner.  Each character gets a class from ``unicodedata.category``
# (letters L*, numbers N*) or the Unicode White_Space property (the ``\s``
# of that pattern; not ``str.isspace``, which adds U+001C-U+001F); the
# scanner then takes the pattern's alternatives in order at each position.
# ``re``'s \w / \d are no substitute: they split No/Nl characters such as
# ² or ½ differently from the published tokenizer.  Letters and numbers are
# those of Python's Unicode database; a newer database (the ``regex``
# module's) differs only on code points the older one leaves unassigned.
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
    "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f"
    "\u3000")


class _CharClasses(dict):
    """Code point -> class letter for ``str.translate``, filled on first
    sight: ``L`` letter, ``N`` number, `` `` U+0020, ``s`` other white
    space, ``'`` the apostrophe, ``o`` anything else."""

    def __missing__(self, cp: int) -> str:
        ch = chr(cp)
        if ch in _WHITE_SPACE:
            c = " " if ch == " " else "s"
        elif ch == "'":
            c = "'"
        else:
            major = unicodedata.category(ch)[0]
            c = major if major in "LN" else "o"
        self[cp] = c
        return c


_CLASSES = _CharClasses()
_CONTRACTION = re.compile(r"'(?:s|t|re|ve|m|ll|d)")
_RUN = {"L": re.compile("L+"), "N": re.compile("N+"),
        "o": re.compile("[o']+"), "'": re.compile("[o']+"),
        " ": re.compile("[ s]+"), "s": re.compile("[ s]+")}


def gpt2_split(text: str) -> list[str]:
    """GPT-2's pretokens of ``text``, as the published pattern's
    ``findall`` gives them."""
    cls = text.translate(_CLASSES)
    n = len(text)
    out = []
    i = 0
    while i < n:
        c = cls[i]
        if c == "'":
            m = _CONTRACTION.match(text, i)
            if m:
                out.append(m.group())
                i = m.end()
                continue
        start = i
        if c == " " and i + 1 < n and cls[i + 1] in "LNo'":
            i += 1  # ` ?` joins the run that follows
            c = cls[i]
        j = _RUN[c].match(cls, i).end()
        if c in " s" and j < n and j - i > 1:
            j -= 1  # \s+(?!\S): the last space joins the next pretoken
        out.append(text[start:j])
        i = j
    return out


class GPT2BPETokenizer:
    """vocab.json + merges.txt byte-level BPE encoder/decoder.

    The merge loop runs in the native C++ engine (tokenizer/native_bpe.py,
    the corpus-preprocessing hot path), which raises if ``g++`` cannot
    build it; ``use_native=False`` runs the Python loop below instead.
    The two give the same ids."""

    def __init__(self, vocab_file: str, merges_file: str,
                 use_native: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        ranks = {}
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()  # CRLF / stray spaces must not
                if not line or line.startswith("#version"):  # corrupt ranks
                    continue
                a, b = line.split()
                ranks[(a, b)] = len(ranks)
        self.bpe_ranks = ranks
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict = {}
        self._id_cache: dict = {}  # pretoken -> ids (native path)
        self._native = None
        if use_native:
            from .native_bpe import NativeBPE

            self._native = NativeBPE(self.encoder, ranks)

    def _bpe(self, token: str) -> list[str]:
        """Merge-loop: repeatedly join the lowest-rank adjacent pair."""
        if token in self._cache:
            return self._cache[token]
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]): i
                     for i in range(len(parts) - 1) if
                     (parts[i], parts[i + 1]) in self.bpe_ranks}
            if not pairs:
                break
            best = min(pairs, key=lambda p: self.bpe_ranks[p])
            merged = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1
                        and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        pretokens = [
            "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for tok in gpt2_split(text)
        ]
        if self._native is not None:
            # id-cache in front of the engine: corpora are Zipfian, so
            # most pretokens are repeats; the C++ merge loop only runs on
            # cache misses (cold/rare tokens, where it is ~10x the Python
            # loop), batched in one call.
            cache = self._id_cache
            misses = [t for t in pretokens if t not in cache]
            if misses:
                uniq = list(dict.fromkeys(misses))
                try:
                    flat, per = self._native.encode_pretokens(uniq)
                    for i, t in enumerate(uniq):
                        cache[t] = flat[per[i]:per[i + 1]]
                except RuntimeError:  # unknown symbol: Python fallback
                    for t in uniq:
                        cache[t] = [self.encoder[p] for p in self._bpe(t)]
            ids: list[int] = []
            for t in pretokens:
                ids.extend(cache[t])
            return ids
        ids = []
        for mapped in pretokens:
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)


# ---------------------------------------------------------------------------
# BERT WordPiece
# ---------------------------------------------------------------------------


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """vocab.txt greedy-longest-match WordPiece with BERT basic
    tokenization (lowercase option, accent stripping, punctuation and
    CJK splitting)."""

    def __init__(self, vocab_file: str, lower_case: bool = True,
                 unk_token: str = "[UNK]", max_word_chars: int = 100,
                 never_split: Optional[Sequence[str]] = None):
        self.vocab: dict = {}
        with open(vocab_file, encoding="utf-8") as f:
            for line in f:
                tok = line.strip()  # CRLF-safe
                if tok:
                    self.vocab[tok] = len(self.vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.lower = lower_case
        self.unk = unk_token
        # max 100 matches the published WordPiece (longer words -> [UNK])
        self.max_word_chars = max_word_chars
        # special tokens survive basic tokenization intact
        self.never_split = set(never_split if never_split is not None else
                               ("[UNK]", "[SEP]", "[PAD]", "[CLS]",
                                "[MASK]"))

    # -- basic tokenizer ---------------------------------------------------

    def _basic_split(self, text: str) -> list[str]:
        text = unicodedata.normalize("NFC", text)
        out = []
        for ch in text:
            cp = ord(ch)
            # whitespace check must precede the control-category check:
            # \t \n \r are category Cc but are separators, not deletions
            if ch.isspace() or ch in "\t\n\r":
                out.append(" ")
            elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in (
                    "Cc", "Cf"):
                continue
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        words = "".join(out).split()
        split = []
        for w in words:
            # special tokens pass through basic tokenization untouched
            # (BasicTokenizer never_split behavior)
            if w in self.never_split:
                split.append(w)
                continue
            if self.lower:
                w = w.lower()
                w = "".join(c for c in unicodedata.normalize("NFD", w)
                            if unicodedata.category(c) != "Mn")
            # split punctuation into standalone tokens
            cur = []
            for ch in w:
                if _is_punctuation(ch):
                    if cur:
                        split.append("".join(cur))
                        cur = []
                    split.append(ch)
                else:
                    cur.append(ch)
            if cur:
                split.append("".join(cur))
        return split

    # -- wordpiece ---------------------------------------------------------

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_word_chars:
            return [self.unk]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in self._basic_split(text):
            for piece in self._wordpiece(word):
                ids.append(self.vocab[piece])
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab[int(i)] for i in ids]
        out = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] = out[-1] + t[2:]
            else:
                out.append(t)
        return " ".join(out)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
