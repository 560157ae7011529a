"""Sequence-classification finetuning, GLUE style (mirror of
``megatron_llm_tpu/tasks/classification.py``).

Reference parity: tasks/glue/finetune.py and tasks/finetune_utils.py: a
BERT encoder with a classification head on the pooled [CLS], finetuned on
``(text_a[, text_b], label)`` rows through
``training.driver.pretrain_custom``.  RACE-style multiple choice is
``tasks/race.py``.

Data: TSV with a header (``sentence1\\tsentence2\\tlabel``, the second
sentence optional) or JSONL with ``{"text_a": .., "text_b": .., "label":
..}``; ``--task mnli|qqp`` reads the GLUE files (``tasks/glue.py``).
``main`` builds the JAX entry's HF tokenizer (``transformers``, which the
card's machine lacks: there ``ClassificationDataset`` is driven with a
native WordPiece tokenizer instead) and trains on the card unless its
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig, RuntimeConfig
from ..models import encdec
from ..models.transformer import _normal
from ..parallel.cross_entropy import cross_entropy


# ---------------------------------------------------------------------------
# Model: BERT encoder + classification head (reference: megatron/model/
# classification.py)
# ---------------------------------------------------------------------------


def init_classification_params(cfg: ModelConfig, num_classes: int,
                               seed: int = 0, *, device=None) -> dict:
    """A BERT without its MLM and NSP heads (dead weight downstream, and
    decoupled weight decay would corrupt them in saved checkpoints) and a
    ``[h, num_classes]`` head."""
    gen, device = encdec._generator(seed, device)
    params = encdec._init_bert(cfg, gen, device)
    params.pop("lm_head")
    params.pop("binary_head")
    params["classification_head"] = {
        "w": _normal((cfg.hidden_size, num_classes), cfg.init_method_std,
                     cfg.dtype, gen, device),
        "b": torch.zeros((num_classes,), dtype=cfg.dtype, device=device),
    }
    return params


def classification_forward(cfg: ModelConfig, params: dict, tokens, pad_mask,
                           tokentype_ids=None, rng=None,
                           deterministic: bool = True) -> torch.Tensor:
    """→ class logits ``[b, num_classes]`` fp32 (pooled [CLS] → dense,
    reference classification.py:70-90)."""
    _, pooled = encdec.bert_encode(cfg, params, tokens, pad_mask,
                                   tokentype_ids, rng, deterministic)
    head = params["classification_head"]
    return (pooled @ head["w"] + head["b"]).float()


def classification_loss(cfg: ModelConfig, params: dict, batch: dict,
                        rng=None, deterministic: bool = True):
    logits = classification_forward(
        cfg, params, batch["tokens"], batch["pad_mask"],
        batch.get("tokentype_ids"), rng, deterministic)
    per = cross_entropy(logits[:, None, :], batch["label"][:, None],
                        vocab_size=logits.shape[-1])
    return torch.mean(per)


def _stacked(samples, key, device, dtype):
    return torch.as_tensor(np.stack([s[key] for s in samples]), dtype=dtype,
                           device=device)


def accuracy(forward, params: dict, dataset, batch_size: int) -> float:
    """The share of ``dataset`` whose argmax of ``forward(params, tokens,
    pad_mask, tokentype_ids)`` is its label, on the params' device."""
    device = params["embedding"]["word"].device
    correct = total = 0
    with torch.no_grad():
        for i in range(0, len(dataset), batch_size):
            samples = [dataset[j]
                       for j in range(i, min(i + batch_size, len(dataset)))]
            logits = forward(
                params, _stacked(samples, "tokens", device, torch.long),
                _stacked(samples, "pad_mask", device, torch.float32),
                _stacked(samples, "tokentype_ids", device, torch.long))
            pred = torch.argmax(logits, -1).cpu().numpy()
            labels = np.asarray([s["label"] for s in samples])
            correct += int((pred == labels).sum())
            total += len(samples)
    return correct / max(total, 1)


def classification_accuracy(cfg: ModelConfig, params: dict,
                            dataset, batch_size: int = 32) -> float:
    return accuracy(lambda p, t, m, tt: classification_forward(
        cfg, p, t, m, tt), params, dataset, batch_size)


# ---------------------------------------------------------------------------
# Dataset (reference: tasks/data_utils.py build_sample / the GLUE dataset)
# ---------------------------------------------------------------------------


class ClassificationDataset:
    def __init__(self, rows: Sequence[tuple], tokenizer, seq_length: int,
                 cls_id: int, sep_id: int, pad_id: int,
                 label_map: Optional[dict] = None):
        self.rows = list(rows)
        self.tok = tokenizer
        self.seq = seq_length
        self.cls, self.sep, self.pad = cls_id, sep_id, pad_id
        if label_map is None:
            labels = sorted({r[2] for r in self.rows})
            label_map = {l: i for i, l in enumerate(labels)}
        else:
            # fail fast on labels the (train-derived) map lacks: a KeyError
            # mid-evaluation would throw away a finished training run
            unknown = sorted({r[2] for r in self.rows} - set(label_map))
            if unknown:
                raise ValueError(
                    f"labels {unknown} not present in the provided "
                    f"label_map (known: {sorted(label_map)})")
        self.label_map = label_map

    @property
    def num_classes(self) -> int:
        return len(self.label_map)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict:
        text_a, text_b, label = self.rows[idx]
        a = list(self.tok.tokenize(text_a))
        b = list(self.tok.tokenize(text_b)) if text_b else []
        # truncate pairwise from the longer side (data_utils semantics)
        while len(a) + len(b) > self.seq - (3 if b else 2):
            (a if len(a) >= len(b) else b).pop()
        tokens = [self.cls] + a + [self.sep] + (b + [self.sep] if b else [])
        tokentypes = [0] * (len(a) + 2) + ([1] * (len(b) + 1) if b else [])
        n = len(tokens)
        pad = self.seq - n
        return {
            "tokens": np.asarray(tokens + [self.pad] * pad, np.int64),
            "tokentype_ids": np.asarray(tokentypes + [0] * pad, np.int64),
            "pad_mask": np.asarray([1.0] * n + [0.0] * pad, np.float32),
            "label": np.int64(self.label_map[label]),
        }


def load_rows(path: str) -> list[tuple]:
    rows = []
    if path.endswith(".jsonl"):
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                rows.append((d["text_a"], d.get("text_b", ""),
                             str(d["label"])))
    else:  # TSV with a header
        with open(path) as f:
            for d in csv.DictReader(f, delimiter="\t"):
                rows.append((d.get("sentence1") or d.get("text_a") or "",
                             d.get("sentence2") or d.get("text_b") or "",
                             str(d["label"])))
    return rows


def encoder_model_config(vocab_size: int, hidden_size: int, num_layers: int,
                         num_attention_heads: int,
                         seq_length: int) -> ModelConfig:
    """The BERT config of the finetuning entries (JAX
    ``tasks/classification.py:main``, ``tasks/race.py:main``)."""
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        num_layers=num_layers,
        num_attention_heads=num_attention_heads,
        num_kv_heads=num_attention_heads,
        ffn_hidden_size=4 * hidden_size,
        max_position_embeddings=seq_length,
        norm_type="layernorm", activation="gelu",
        position_embedding_type="absolute", use_bias=True,
        tie_embed_logits=True, tokentype_size=2,
        seq_length=seq_length,
    )


def load_pretrained_trunk(path: str, params: dict, head: str) -> dict:
    """``params`` with every leaf but ``head``'s read from the BERT release
    checkpoint at ``path`` (``checkpointing.load_release_params``)."""
    from .. import checkpointing

    template = {k: v for k, v in params.items() if k != head}
    params.update(checkpointing.load_release_params(path, template))
    return params


# ---------------------------------------------------------------------------
# CLI (reference: tasks/main.py + the GLUE finetune drivers)
# ---------------------------------------------------------------------------


def main(argv: Optional[list] = None, device=None) -> dict:
    from ..config import OptimizerConfig, ParallelConfig, TrainConfig
    from ..tokenizer.tokenizer import build_tokenizer
    from ..training.driver import pretrain_custom

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", default="generic",
                   choices=["generic", "mnli", "qqp"],
                   help="generic = header TSV/JSONL; mnli/qqp parse the "
                        "GLUE distributions' shipped formats "
                        "(tasks/glue.py)")
    p.add_argument("--train_data", required=True)
    p.add_argument("--valid_data", required=True)
    p.add_argument("--tokenizer_model", default="bert-base-uncased")
    p.add_argument("--pretrained_checkpoint", default=None,
                   help="BERT release checkpoint to start from")
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--seq_length", type=int, default=128)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--micro_batch_size", type=int, default=8)
    p.add_argument("--global_batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)

    tok = build_tokenizer("huggingface", args.tokenizer_model)
    inner = tok.inner
    model = encoder_model_config(tok.vocab_size, args.hidden_size,
                                 args.num_layers, args.num_attention_heads,
                                 args.seq_length)
    if args.task == "generic":
        train_rows, valid_rows = (load_rows(args.train_data),
                                  load_rows(args.valid_data))
        label_map = None
    else:
        from .glue import load_glue_rows

        train_rows, label_map = load_glue_rows(args.task, args.train_data)
        valid_rows, _ = load_glue_rows(args.task, args.valid_data)
    ids = (inner.cls_token_id, inner.sep_token_id, inner.pad_token_id or 0)
    train_ds = ClassificationDataset(train_rows, tok, args.seq_length, *ids,
                                     label_map=label_map)
    valid_ds = ClassificationDataset(valid_rows, tok, args.seq_length, *ids,
                                     label_map=train_ds.label_map)

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

    params = init_classification_params(cfg.model, train_ds.num_classes,
                                        args.seed, device=device)
    if args.pretrained_checkpoint:
        params = load_pretrained_trunk(args.pretrained_checkpoint, params,
                                       "classification_head")

    def loss_fn(rcfg, p, mb, rng, deterministic):
        return classification_loss(rcfg.model, p, mb, rng, deterministic)

    state = pretrain_custom(cfg, train_ds, params, loss_fn, device=device)
    acc = classification_accuracy(cfg.model, state.params, valid_ds)
    print(json.dumps({"task": "classification", "valid_accuracy": acc,
                      "num_classes": train_ds.num_classes,
                      "iterations": int(state.iteration)}))
    return {"accuracy": acc, "state": state}


if __name__ == "__main__":
    main()
