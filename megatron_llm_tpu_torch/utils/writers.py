"""Tensorboard / Weights&Biases scalar writers (mirror of
``megatron_llm_tpu/utils/writers.py``).

Reference: megatron/global_vars.py:128-162 picks a tensorboard
``SummaryWriter`` or the wandb shim (megatron/wandb_logger.py:13-60 —
``WandbTBShim`` exposing the tensorboard API over ``wandb.log``) on the
last rank.  Both integrations are optional; a ``NullWriter`` stands in when
neither backend is importable or configured.
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


class WandbTBShim:
    """Tensorboard-API adapter over wandb (reference wandb_logger.py:13-60)."""

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[dict] = None):
        import wandb  # gated: raises ImportError when absent

        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, config=config,
                               resume="allow")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._wandb.log({tag: value}, step=step)

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        self._wandb.log({tag: text}, step=step)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._run.finish()


def build_writer(tensorboard_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_name: Optional[str] = None,
                 config: Optional[dict] = None):
    """Writer dispatch (reference global_vars.py:128-162): wandb wins when
    both are configured, mirroring _set_wandb_writer precedence."""
    if wandb_project:
        try:
            return WandbTBShim(wandb_project, wandb_name, config)
        except ImportError:
            print("WARNING: wandb requested but not installed; "
                  "falling back to tensorboard/null writer", flush=True)
    if tensorboard_dir:
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(log_dir=tensorboard_dir)
        except ImportError:
            print("WARNING: tensorboard not available; metrics will not be "
                  "exported", flush=True)
    return NullWriter()
