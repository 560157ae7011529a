"""Scalar writers for the training log (mirror of
``megatron_llm_tpu/utils/writers.py``).

Only ``NullWriter`` is ported: TensorBoard and Weights & Biases export
raise, naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Optional


class NullWriter:
    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def build_writer(tensorboard_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_name: Optional[str] = None,
                 config: Optional[dict] = None):
    """``NullWriter``, or ``NotImplementedError`` for an export the port
    does not have."""
    if tensorboard_dir or wandb_project:
        raise NotImplementedError(
            "TensorBoard / wandb export is not ported yet (ROADMAP.md, "
            "Queue 1 item 7: training I/O)")
    return NullWriter()
