"""Merge multiple .bin/.idx indexed datasets into one (mirror of
``megatron_llm_tpu/tools/merge_datasets.py``).

Parity: reference tools/merge_datasets.py (append via builder.merge_file_).

Usage:
  python -m megatron_llm_tpu_torch.tools.merge_datasets \
      --input ds_a ds_b ds_c --output_prefix merged
"""

from __future__ import annotations

import argparse
from typing import Optional

from ..data.indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder


def merge(prefixes: list[str], output_prefix: str) -> int:
    """Append each input dataset in order; returns total document count."""
    first = MMapIndexedDataset(prefixes[0])
    builder = MMapIndexedDatasetBuilder(output_prefix, dtype=first.dtype)
    for prefix in prefixes:
        builder.merge_file(prefix)
    builder.finalize()
    merged = MMapIndexedDataset(output_prefix)
    return len(merged)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", nargs="+", required=True,
                   help="input dataset prefixes (paths without .bin/.idx)")
    p.add_argument("--output_prefix", required=True)
    args = p.parse_args(argv)
    n = merge(args.input, args.output_prefix)
    print(f"merged {len(args.input)} datasets -> {args.output_prefix} "
          f"({n} documents)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
