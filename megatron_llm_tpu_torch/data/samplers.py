"""Resumable deterministic samplers and the host-side batch iterator (the
port's own copy of ``megatron_llm_tpu/data/samplers.py``).

Parity with the reference samplers (megatron/data/data_samplers.py:14-187):
- ``PretrainingSampler``: sequential batches offset by ``consumed_samples``
  so a run resumed from a checkpoint continues exactly where it left off
- ``RandomSampler``: epoch-bucketed deterministic shuffle (epoch =
  consumed_samples // len(dataset)), also resumable
- ``BatchIterator``: assembles [accum, global_batch, seq] numpy batches for
  the train step — tokens/labels/loss_mask (the reference splits text into
  tokens/labels in finetune.get_batch, finetune.py:117-146)

The port trains on one device, so the iterator yields the whole global
batch and no rank arithmetic appears in the sampler.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class PretrainingSampler:
    """Sequential resumable sampler (reference data_samplers.py:49-96)."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 batch_size: int, drop_last: bool = True):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.batch_size = batch_size
        self.drop_last = drop_last
        if not 0 <= self.consumed_samples < self.total_samples:
            raise ValueError(f"consumed_samples {consumed_samples} outside "
                             f"a dataset of {total_samples} samples")

    def __len__(self):
        return self.total_samples

    def __iter__(self) -> Iterator[list[int]]:
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class RandomSampler:
    """Epoch-shuffled resumable sampler (reference data_samplers.py:120-187)."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 batch_size: int, seed: int = 1234):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return self.total_samples

    def __iter__(self) -> Iterator[list[int]]:
        # Each epoch yields only the full batches; resume arithmetic must use
        # that *active* count, not total_samples (reference
        # data_samplers.py:150-156), or a resumed run replays/skips samples.
        active = self.total_samples - (self.total_samples % self.batch_size)
        if active <= 0:
            raise ValueError("batch_size larger than dataset")
        epoch = self.consumed_samples // active
        current = self.consumed_samples % active
        while True:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(self.total_samples)[:active]
            batch = []
            for idx in order[current:]:
                batch.append(int(idx))
                if len(batch) == self.batch_size:
                    yield batch
                    batch = []
            epoch += 1
            current = 0


class BatchIterator:
    """Assemble train-step batches from an indexed sample dataset.

    Yields dicts of numpy arrays shaped [accum, micro_batch, seq]; the
    train loop moves them to the device.
    """

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        grad_accum: int,
        seq_length: int,
        consumed_samples: int = 0,
        shuffle: bool = False,
        seed: int = 1234,
        eod_token: Optional[int] = None,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.global_batch = global_batch_size
        self.accum = grad_accum
        self.micro_total = global_batch_size // grad_accum
        self.seq_length = seq_length
        self.eod = eod_token
        sampler_cls = RandomSampler if shuffle else PretrainingSampler
        kwargs = dict(
            total_samples=len(dataset),
            consumed_samples=consumed_samples,
            batch_size=global_batch_size,
        )
        if shuffle:
            kwargs["seed"] = seed
        else:
            kwargs["drop_last"] = drop_last
        self.sampler = sampler_cls(**kwargs)

    def __iter__(self):
        for idxs in self.sampler:
            samples = [self.dataset[i] for i in idxs]
            yield self.collate(samples)

    def collate(self, samples: list[dict]) -> dict:
        if "text" in samples[0]:
            text = np.stack([s["text"] for s in samples])  # [gb, seq+1]
            tokens = text[:, :-1]
            labels = text[:, 1:]
            loss_mask = np.ones_like(tokens, dtype=np.float32)
        else:  # instruction samples carry explicit fields
            tokens = np.stack([s["tokens"] for s in samples])
            labels = np.stack([s["labels"] for s in samples])
            loss_mask = np.stack([s["loss_mask"] for s in samples]
                                 ).astype(np.float32)
        if self.eod is not None:
            # loss is not computed on eod paddings (reference
            # get_ltor_masks_and_position_ids eod_mask_loss,
            # megatron/utils.py:137-194)
            loss_mask = loss_mask * (labels != self.eod)

        def split(x):
            if x.shape[0] != self.global_batch:
                raise ValueError(f"batch of {x.shape[0]} samples, want "
                                 f"{self.global_batch}")
            return x.reshape(self.accum, self.micro_total, *x.shape[1:])

        batch = {
            "tokens": split(tokens.astype(np.int32)),
            "labels": split(labels.astype(np.int32)),
            "loss_mask": split(loss_mask),
        }
        for extra in ("position_ids", "segment_ids"):
            if extra in samples[0]:
                batch[extra] = split(
                    np.stack([s[extra] for s in samples]).astype(np.int32))
        return batch
