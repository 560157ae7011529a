"""Weighted blend of multiple datasets (mirror of
``megatron_llm_tpu/data/blendable_dataset.py``; reference:
megatron/data/blendable_dataset.py:12-55)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import index_helpers


class BlendableDataset:
    def __init__(self, datasets: Sequence, weights: Sequence[float],
                 size: int | None = None):
        assert len(datasets) == len(weights) > 0
        self.datasets = list(datasets)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        if size is None:
            size = sum(len(d) for d in datasets)
        self.size = size
        self.dataset_index, self.dataset_sample_index = (
            index_helpers.build_blending_indices(w, size))
        # Guard: the greedy interleave can request one sample beyond a
        # dataset's length at the tail; clamp within each dataset.
        for i, d in enumerate(self.datasets):
            sel = self.dataset_index == i
            self.dataset_sample_index[sel] = np.minimum(
                self.dataset_sample_index[sel], len(d) - 1)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        d = self.dataset_index[idx]
        s = self.dataset_sample_index[idx]
        return self.datasets[d][s]


def parse_data_paths(paths: Sequence) -> tuple[list[float], list[str]]:
    """['0.3', 'corpusA', '0.7', 'corpusB'] or ['corpus'] → (weights, prefixes)
    (reference: dataset_utils.get_datasets_weights_and_num_samples)."""
    paths = list(paths)
    if len(paths) == 1:
        return [1.0], [str(paths[0])]
    assert len(paths) % 2 == 0, "expect alternating weight/prefix pairs"
    weights = [float(paths[i]) for i in range(0, len(paths), 2)]
    prefixes = [str(paths[i]) for i in range(1, len(paths), 2)]
    return weights, prefixes
