"""RACE multiple-choice reading comprehension (mirror of
``megatron_llm_tpu/tasks/race.py``).

Reference parity: tasks/race/data.py (directories of ``.txt`` JSON lines
with article / questions / options / answers, the "_" cloze substitution,
four choices flattened) and megatron/model/multiple_choice.py (the BERT
encoder with a 1-output head scored per choice; the choices fold into the
batch and the softmax runs over each question's four scores).  ``main``
builds the JAX entry's HF tokenizer and trains on the card unless its
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import encdec
from ..models.transformer import _normal
from ..parallel.cross_entropy import cross_entropy
from .classification import accuracy
from .glue import clean_text

NUM_CHOICES = 4
MAX_QA_LENGTH = 128


def read_race_questions(datapath: str) -> list[dict]:
    """Every ``*.txt`` under ``datapath`` (a JSON article a line) →
    ``[{"context", "qas": [4 question + choice strings], "label"}]``.
    A cloze question takes the choice in place of "_"; any other has it
    appended (reference race/data.py:96-105)."""
    out = []
    for filename in sorted(glob.glob(os.path.join(datapath, "*.txt"))):
        with open(filename) as f:
            for line in f:
                if not line.strip():
                    continue
                data = json.loads(line)
                context = clean_text(data["article"])
                questions = data["questions"]
                choices = data["options"]
                answers = data["answers"]
                assert len(questions) == len(answers) == len(choices)
                for q, opts, ans in zip(questions, choices, answers):
                    label = ord(ans) - ord("A")
                    assert 0 <= label < NUM_CHOICES
                    assert len(opts) == NUM_CHOICES
                    qas = [
                        clean_text(q.replace("_", c) if "_" in q
                                   else " ".join([q, c]))
                        for c in opts
                    ]
                    out.append({"context": context, "qas": qas,
                                "label": label})
    return out


class RaceDataset:
    """Each item: the four choice encodings stacked on a leading axis
    (tokens / tokentype_ids / pad_mask ``[4, seq]``) and the answer's
    index: the reference's sample_multiplier=4 batch fold, explicit."""

    def __init__(self, datapaths: Sequence[str], tokenizer, seq_length: int,
                 cls_id: int, sep_id: int, pad_id: int,
                 max_qa_length: int = MAX_QA_LENGTH):
        self.samples = []
        for p in datapaths:
            self.samples.extend(read_race_questions(p))
        self.tok = tokenizer
        self.seq = seq_length
        self.cls, self.sep, self.pad = cls_id, sep_id, pad_id
        self.max_qa = max_qa_length

    def __len__(self) -> int:
        return len(self.samples)

    def _encode_one(self, qa: str, context_ids: list) -> tuple:
        # the qa capped at seq - 3 as well as max_qa: a row is always
        # seq_length long, even where max_qa_length + 3 > seq_length
        qa_ids = list(self.tok.tokenize(qa))[: min(self.max_qa, self.seq - 3)]
        # trim the context's tail alone (reference data_utils
        # build_tokens_types_paddings_from_ids truncates text_b)
        room = self.seq - 3 - len(qa_ids)
        ctx = list(context_ids)[: max(room, 0)]
        tokens = [self.cls] + qa_ids + [self.sep] + ctx + [self.sep]
        types = [0] * (len(qa_ids) + 2) + [1] * (len(ctx) + 1)
        n = len(tokens)
        pad = self.seq - n
        return (tokens + [self.pad] * pad, types + [0] * pad,
                [1.0] * n + [0.0] * pad)

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx]
        context_ids = list(self.tok.tokenize(s["context"]))
        enc = [self._encode_one(qa, context_ids) for qa in s["qas"]]
        tokens, types, mask = zip(*enc)
        return {
            "tokens": np.asarray(tokens, np.int64),          # [4, seq]
            "tokentype_ids": np.asarray(types, np.int64),
            "pad_mask": np.asarray(mask, np.float32),
            "label": np.int64(s["label"]),
        }


# ---------------------------------------------------------------------------
# Model: BERT encoder + a scalar score per choice
# (reference: megatron/model/multiple_choice.py)
# ---------------------------------------------------------------------------


def init_multichoice_params(cfg: ModelConfig, seed: int = 0, *,
                            device=None) -> dict:
    gen, device = encdec._generator(seed, device)
    params = encdec._init_bert(cfg, gen, device)
    params.pop("lm_head")
    params.pop("binary_head")
    params["multichoice_head"] = {
        "w": _normal((cfg.hidden_size, 1), cfg.init_method_std, cfg.dtype,
                     gen, device),
        "b": torch.zeros((1,), dtype=cfg.dtype, device=device),
    }
    return params


def multichoice_forward(cfg: ModelConfig, params: dict, tokens, pad_mask,
                        tokentype_ids, rng=None,
                        deterministic: bool = True) -> torch.Tensor:
    """tokens ``[b, 4, seq]`` → each question's choice logits ``[b, 4]``
    fp32."""
    b, c, s = tokens.shape

    def flat(x):
        return x.reshape(b * c, s)

    _, pooled = encdec.bert_encode(
        cfg, params, flat(tokens), flat(pad_mask), flat(tokentype_ids),
        rng, deterministic)
    head = params["multichoice_head"]
    return (pooled @ head["w"] + head["b"]).float().reshape(b, c)


def multichoice_loss(cfg: ModelConfig, params: dict, batch: dict,
                     rng=None, deterministic: bool = True):
    logits = multichoice_forward(
        cfg, params, batch["tokens"], batch["pad_mask"],
        batch["tokentype_ids"], rng, deterministic)
    per = cross_entropy(logits[:, None, :], batch["label"][:, None],
                        vocab_size=NUM_CHOICES)
    return torch.mean(per)


def multichoice_accuracy(cfg: ModelConfig, params: dict, dataset,
                         batch_size: int = 8) -> float:
    return accuracy(lambda p, t, m, tt: multichoice_forward(
        cfg, p, t, m, tt), params, dataset, batch_size)


# ---------------------------------------------------------------------------
# CLI (reference: tasks/race/finetune.py)
# ---------------------------------------------------------------------------


def main(argv: Optional[list] = None, device=None) -> dict:
    import argparse

    from ..config import (OptimizerConfig, ParallelConfig, RuntimeConfig,
                          TrainConfig)
    from ..tokenizer.tokenizer import build_tokenizer
    from ..training.driver import pretrain_custom
    from .classification import encoder_model_config, load_pretrained_trunk

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_data", required=True, nargs="+",
                   help="RACE dirs of .txt files (e.g. train/middle "
                        "train/high)")
    p.add_argument("--valid_data", required=True, nargs="+")
    p.add_argument("--tokenizer_model", default="bert-base-uncased")
    p.add_argument("--pretrained_checkpoint", default=None)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--seq_length", type=int, default=512)
    p.add_argument("--max_qa_length", type=int, default=MAX_QA_LENGTH)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--micro_batch_size", type=int, default=4)
    p.add_argument("--global_batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)

    tok = build_tokenizer("huggingface", args.tokenizer_model)
    inner = tok.inner
    model = encoder_model_config(tok.vocab_size, args.hidden_size,
                                 args.num_layers, args.num_attention_heads,
                                 args.seq_length)
    ds_args = (tok, args.seq_length, inner.cls_token_id,
               inner.sep_token_id, inner.pad_token_id or 0)
    train_ds = RaceDataset(args.train_data, *ds_args,
                           max_qa_length=args.max_qa_length)
    valid_ds = RaceDataset(args.valid_data, *ds_args,
                           max_qa_length=args.max_qa_length)

    iters = max(1, args.epochs * len(train_ds) // args.global_batch_size)
    cfg = RuntimeConfig(
        model=model,
        parallel=ParallelConfig(),
        optimizer=OptimizerConfig(lr=args.lr, clip_grad=1.0),
        train=TrainConfig(
            train_iters=iters, micro_batch_size=args.micro_batch_size,
            global_batch_size=args.global_batch_size,
            seq_length=args.seq_length, seed=args.seed, save=args.save,
        ),
    ).validate()

    params = init_multichoice_params(cfg.model, args.seed, device=device)
    if args.pretrained_checkpoint:
        params = load_pretrained_trunk(args.pretrained_checkpoint, params,
                                       "multichoice_head")

    def loss_fn(rcfg, p, mb, rng, deterministic):
        return multichoice_loss(rcfg.model, p, mb, rng, deterministic)

    state = pretrain_custom(cfg, train_ds, params, loss_fn, device=device)
    acc = multichoice_accuracy(cfg.model, state.params, valid_ds)
    print(json.dumps({"task": "race", "valid_accuracy": acc,
                      "iterations": int(state.iteration)}))
    return {"accuracy": acc, "state": state}


if __name__ == "__main__":
    main()
