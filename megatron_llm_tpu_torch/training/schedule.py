"""Learning-rate and weight-decay schedules (mirror of
``megatron_llm_tpu/training/schedule.py``; reference
``OptimizerParamScheduler``, megatron/optimizer_param_scheduler.py:10-228).

Pure functions of the iteration, evaluated on the host in numpy float32
with the JAX package's formulas and operation order, so both packages give
the same fp32 value; the result is a Python float.
"""

from __future__ import annotations

import numpy as np

from ..config import OptimizerConfig

_f = np.float32


def learning_rate(cfg: OptimizerConfig, it: int, train_iters: int) -> float:
    """lr at iteration ``it`` (0-based): linear warmup, then constant,
    linear, cosine or inverse-square-root decay to ``min_lr``."""
    it = _f(it)
    warmup = float(cfg.lr_warmup_iters)
    if cfg.lr_warmup_fraction is not None:
        warmup = float(cfg.lr_warmup_fraction) * (
            cfg.lr_decay_iters or train_iters)
    decay_iters = float(cfg.lr_decay_iters or train_iters)
    max_lr, min_lr = cfg.lr, cfg.min_lr

    warm_lr = _f(max_lr) * (it + _f(1.0)) / _f(max(warmup, 1.0))
    progress = np.clip((it - _f(warmup)) / _f(max(decay_iters - warmup, 1.0)),
                       _f(0.0), _f(1.0))
    style = cfg.lr_decay_style
    if style == "constant":
        decayed = _f(max_lr)
    elif style == "linear":
        decayed = _f(max_lr) + _f(min_lr - max_lr) * progress
    elif style == "cosine":
        decayed = _f(min_lr) + _f(0.5 * (max_lr - min_lr)) * (
            _f(1.0) + np.cos(_f(np.pi) * progress))
    elif style == "inverse-square-root":
        decayed = (_f(max_lr) * np.sqrt(_f(max(warmup, 1.0)))
                   / np.sqrt(it + _f(1.0)))
        decayed = np.maximum(decayed, _f(min_lr))
    else:
        raise ValueError(f"unknown lr_decay_style {style!r}")
    return float(_f(warm_lr if it < warmup else decayed))


def weight_decay(cfg: OptimizerConfig, it: int, train_iters: int) -> float:
    """Weight decay at iteration ``it`` (reference:
    optimizer_param_scheduler.py:42-64)."""
    if cfg.weight_decay_incr_style == "constant" \
            or cfg.start_weight_decay is None:
        return float(_f(cfg.weight_decay))
    start = cfg.start_weight_decay
    end = (cfg.end_weight_decay if cfg.end_weight_decay is not None
           else cfg.weight_decay)
    frac = np.clip(_f(it) / _f(max(train_iters, 1)), _f(0.0), _f(1.0))
    if cfg.weight_decay_incr_style == "linear":
        return float(_f(_f(start) + _f(end - start) * frac))
    if cfg.weight_decay_incr_style == "cosine":
        return float(_f(_f(end) + _f(start - end) * _f(0.5)
                        * (_f(1.0) + np.cos(_f(np.pi) * frac))))
    raise ValueError(
        f"unknown weight_decay_incr_style {cfg.weight_decay_incr_style!r}")
