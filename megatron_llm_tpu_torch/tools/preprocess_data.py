"""Preprocess jsonl corpora into .bin/.idx indexed datasets (mirror of
``megatron_llm_tpu/tools/preprocess_data.py``: the same jsonl, tokenizer
and flags give the same bytes).

Parity with the reference tools (tools/preprocess_data.py:201 and
tools/preprocess_instruct_data.py): multiprocess tokenization of jsonl
records into the MMap format; the instruction variant emits parallel
``_text_document`` / ``_role_document`` streams with per-token role tags.

Usage:
  python -m megatron_llm_tpu_torch.tools.preprocess_data \
      --input corpus.jsonl --output_prefix corpus \
      --tokenizer_type gpt2-bpe --tokenizer_model VOCAB_DIR \
      --json_key text --append_eod --workers 8
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time

import numpy as np

from ..data.indexed_dataset import MMapIndexedDatasetBuilder, best_dtype
from ..tokenizer.tokenizer import build_tokenizer

_worker_tok = None
_worker_args = None


def _init_worker(args):
    global _worker_tok, _worker_args
    _worker_args = args
    _worker_tok = build_tokenizer(
        args.tokenizer_type, args.tokenizer_model,
        vocab_extra_ids_list=(args.vocab_extra_ids_list.split(",")
                              if args.vocab_extra_ids_list else None),
    )


def _encode_text(line: str):
    """jsonl line → list of token arrays (one per json_key)."""
    data = json.loads(line)
    out = []
    for key in _worker_args.json_keys:
        text = data[key]
        ids = _worker_tok.tokenize(text)
        if _worker_args.append_eod:
            ids = list(ids) + [_worker_tok.eod]
        out.append(np.asarray(ids, dtype=np.int64))
    return out, len(line)


def _encode_instruction(line: str):
    """Conversation jsonl → (text tokens, role tags) streams.

    Expected record: {"conversation": [{"role": "system|prompter|assistant",
    "text": ...}, ...]} (reference preprocess_instruct_data layout).
    """
    from ..data.instruction_dataset import Role

    data = json.loads(line)
    # explicit key precedence (an `or`-chain would misroute records whose
    # first-listed key holds an empty list)
    turns = next((data[k] for k in ("conversation", "messages",
                                    "conversations") if k in data), None)
    if turns is None:
        raise ValueError(
            "instruction record needs a 'conversation' / 'messages' / "
            f"'conversations' turn list; record keys: {sorted(data)}")
    text_ids: list[int] = []
    role_ids: list[int] = []
    if _worker_tok.bos is not None:
        text_ids.append(_worker_tok.bos)
        role_ids.append(int(Role.system))
    for turn in turns:
        # role: OpenAI/OASST "role" or ShareGPT "from" naming
        role_name = turn.get("role") or turn.get("from") or "prompter"
        role = {"system": Role.system, "user": Role.prompter,
                "human": Role.prompter, "prompter": Role.prompter,
                "assistant": Role.assistant,
                "gpt": Role.assistant}.get(role_name, Role.prompter)
        # text: "text" (OASST) / "content" (OpenAI) / "value" (ShareGPT)
        text = next((turn[k] for k in ("text", "content", "value")
                     if k in turn), None)
        if text is None:
            raise ValueError(
                f"instruction turn needs 'text'/'content'/'value'; "
                f"turn keys: {sorted(turn)}")
        ids = _worker_tok.tokenize(text)
        if role == Role.assistant and _worker_args.append_eod:
            ids = list(ids) + [_worker_tok.eod]
        text_ids.extend(ids)
        role_ids.extend([int(role)] * len(ids))
    return ([np.asarray(text_ids, dtype=np.int64),
             np.asarray(role_ids, dtype=np.int64)], len(line))


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="jsonl input file")
    p.add_argument("--output_prefix", required=True)
    p.add_argument("--json_keys", nargs="+", default=["text"])
    p.add_argument("--tokenizer_type", default="huggingface")
    p.add_argument("--tokenizer_model", default=None)
    p.add_argument("--vocab_extra_ids_list", default=None)
    p.add_argument("--append_eod", action="store_true")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--instruction_data", action="store_true",
                   help="emit parallel text/role streams")
    p.add_argument("--log_interval", type=int, default=10000)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the datasets; returns ``{"documents", "tokens", "seconds"}``
    (tokens of the first stream, seconds of the tokenizing loop)."""
    args = get_args(argv)
    _init_worker(args)
    vocab = _worker_tok.vocab_size
    dtype = best_dtype(vocab)

    if args.instruction_data:
        keys = ["text", "role"]
        suffixes = ["_text_document", "_role_document"]
        encode = _encode_instruction
    else:
        keys = args.json_keys
        suffixes = (["_document"] if len(keys) == 1
                    else [f"_{k}_document" for k in keys])
        encode = _encode_text

    builders = [
        MMapIndexedDatasetBuilder(args.output_prefix + sfx,
                                  np.int64 if k == "role" else dtype)
        for k, sfx in zip(keys, suffixes)
    ]

    t0 = time.time()
    n = 0
    n_tokens = 0
    with open(args.input, "r", encoding="utf-8") as f:
        if args.workers > 1:
            pool = mp.Pool(args.workers, initializer=_init_worker,
                           initargs=(args,))
            stream = pool.imap(encode, f, chunksize=32)
        else:
            stream = map(encode, f)
        for docs, _nbytes in stream:
            for builder, ids in zip(builders, docs):
                builder.add_doc(ids)
            n += 1
            n_tokens += len(docs[0])
            if n % args.log_interval == 0:
                rate = n / (time.time() - t0)
                print(f"processed {n} documents ({rate:.0f} docs/s)",
                      file=sys.stderr)
        if args.workers > 1:
            pool.close()
            pool.join()

    seconds = time.time() - t0
    for builder in builders:
        builder.finalize()
    print(f"done: {n} documents, {n_tokens} tokens in {seconds:.3f} s → "
          f"{args.output_prefix}*.bin/.idx "
          f"(dtype {np.dtype(dtype).name}, vocab {vocab})")
    return {"documents": n, "tokens": n_tokens, "seconds": seconds}


if __name__ == "__main__":
    main()
