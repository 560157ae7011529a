"""Instruction-tuning dataset: role-tagged token streams with weighted loss
masks (mirror of ``megatron_llm_tpu/data/instruction_dataset.py``).

Parity with the reference instruction pipeline
(megatron/data/instruction_dataset.py:20-355 + the collator/loss-mask logic
in finetune.py:100-161): each document is a pair of parallel token streams —
``text`` (token ids) and ``role`` (per-token Role tag).  At batch time,
samples are padded/truncated to seq_length+1 and the loss mask is:
  1.0 on assistant tokens, 0.0 on padding, ``scalar_loss_mask`` elsewhere
(so non-assistant context can contribute a down-weighted loss).
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from .gpt_dataset import get_train_valid_test_split
from .indexed_dataset import MMapIndexedDataset


class Role(IntEnum):
    system = 0
    prompter = 1
    assistant = 2


class InstructionDataset:
    def __init__(self, name: str, sample_indices: np.ndarray,
                 indexed_text: MMapIndexedDataset,
                 indexed_role: MMapIndexedDataset,
                 seq_length: int,
                 pad_token: int = 0,
                 scalar_loss_mask: float = 0.0):
        assert len(indexed_text) == len(indexed_role)
        assert np.min(sample_indices) >= 0
        assert np.max(sample_indices) < len(indexed_text)
        self.name = name
        self.sample_indices = sample_indices
        self.text = indexed_text
        self.role = indexed_role
        self.seq_length = seq_length
        self.pad_token = pad_token
        self.scalar_loss_mask = scalar_loss_mask

    def __len__(self) -> int:
        return self.sample_indices.shape[0]

    def __getitem__(self, idx: int) -> dict:
        i = int(self.sample_indices[idx])
        text = np.asarray(self.text[i], dtype=np.int64)
        role = np.asarray(self.role[i], dtype=np.int64)
        assert text.shape == role.shape
        s = self.seq_length
        # pad/truncate to seq_length+1 (tokens/labels are shifted views)
        n = text.shape[0]
        if n < s + 1:
            pad = np.full(s + 1 - n, self.pad_token, dtype=np.int64)
            text = np.concatenate([text, pad])
            role = np.concatenate([role, np.full(s + 1 - n, -1,
                                                 dtype=np.int64)])
        else:
            text = text[: s + 1]
            role = role[: s + 1]

        tokens = text[:-1]
        labels = text[1:]
        label_role = role[1:]
        # loss mask semantics of finetune.py:148-161
        loss_mask = np.full(s, self.scalar_loss_mask, dtype=np.float32)
        loss_mask[label_role == Role.assistant] = 1.0
        loss_mask[label_role == -1] = 0.0  # padding
        return {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
            "loss_mask": loss_mask,
        }


def build_instruction_datasets(
    data_prefix: str,
    splits_string: str,
    seq_length: int,
    seed: int,
    pad_token: int = 0,
    scalar_loss_mask: float = 0.0,
):
    """train/valid/test InstructionDatasets from a '<prefix>_text'/
    '<prefix>_role' indexed-dataset pair (reference layout:
    instruction_dataset.py get_indexed_datasets_)."""
    text = MMapIndexedDataset(f"{data_prefix}_text_document")
    role = MMapIndexedDataset(f"{data_prefix}_role_document")
    total = len(text)
    rng = np.random.RandomState(seed)
    order = rng.permutation(total).astype(np.int32)
    splits = get_train_valid_test_split(splits_string, total)
    out = []
    for i, name in enumerate(["train", "valid", "test"]):
        if splits[i + 1] > splits[i]:
            out.append(InstructionDataset(
                name, order[splits[i]:splits[i + 1]], text, role,
                seq_length, pad_token, scalar_loss_mask))
        else:
            out.append(None)
    return tuple(out)
