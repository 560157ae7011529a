"""Mixed-precision AdamW/SGD with fp32 master weights, grad clipping and
loss scaling (mirror of ``megatron_llm_tpu/training/optimizer.py``).

The math is the JAX package's leaf for leaf: fp32 moments; fp32 master
copies when the params are bf16/fp16, with the params refreshed from the
master after each step; weight decay on matmul weights only
(``_wd_mask``); one global L2 norm over the grads.  Where the JAX
functions return new trees, these update in place: the moments, the
master, the params and (in ``clip_by_global_norm``) the grads.  At
Llama-2-7B width that keeps one copy of each instead of two, which is what
lets an 8-layer stack's optimizer state fit the card beside its
activations.  ``zero1_specs`` / ``opt_state_specs`` (ZeRO-1) come with the
parallel slice (ROADMAP.md, Queue 1: data, tensor and sequence parallel
training).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..config import OptimizerConfig
from ..utils.tree import tree_leaves, tree_leaves_with_path, tree_map

PyTree = Any


class ScalerState(NamedTuple):
    """Dynamic loss scaler (reference: grad_scaler.py:53-121); host
    numbers, since the step reads ``found_inf`` on the host anyway."""

    scale: float
    growth_tracker: int  # consecutive good steps
    hysteresis: int      # remaining bad steps before backoff; -1 = constant


class OptState(NamedTuple):
    step: int                  # successful updates so far
    mu: PyTree                 # first moment (fp32)
    nu: Optional[PyTree]       # second moment (fp32); None for sgd
    master: Optional[PyTree]   # fp32 master params; None if params are fp32
    scaler: Optional[ScalerState]


def _needs_master(params) -> bool:
    return any(p.dtype in (torch.bfloat16, torch.float16)
               for p in tree_leaves(params))


def init_scaler(cfg: OptimizerConfig) -> Optional[ScalerState]:
    if cfg.loss_scale is not None:
        # a constant scaler: dynamic state that never updates
        return ScalerState(float(cfg.loss_scale), 0, -1)
    return None


def init_dynamic_scaler(cfg: OptimizerConfig) -> ScalerState:
    return ScalerState(float(cfg.initial_loss_scale), 0, int(cfg.hysteresis))


def init_opt_state(params: PyTree, cfg: OptimizerConfig,
                   use_fp16_scaler: bool = False) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    master = None
    if _needs_master(params):
        # a copy even of an fp32 leaf, so master and param never alias
        master = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    scaler = init_dynamic_scaler(cfg) if use_fp16_scaler else init_scaler(cfg)
    return OptState(
        step=0,
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params) if cfg.optimizer == "adamw" else None,
        master=master,
        scaler=scaler,
    )


def global_grad_norm(grads: PyTree) -> torch.Tensor:
    """One L2 norm over every grad leaf (fp32, a 0-d tensor)."""
    norms = [torch.linalg.vector_norm(g.float()) for g in tree_leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: PyTree, max_norm: float, norm=None):
    """Scale the grads IN PLACE so their global norm is at most
    ``max_norm``; returns ``(grads, norm)``."""
    if norm is None:
        norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(factor.to(g.dtype))
    return grads, norm


def count_zeros(grads: PyTree) -> torch.Tensor:
    """Zero-grad diagnostic (reference clip_grads.py:110-136)."""
    return torch.stack([torch.sum(g == 0) for g in tree_leaves(grads)]).sum()


def _wd_mask(params: PyTree) -> PyTree:
    """1.0 for matmul weights, 0.0 for norm scales and biases (reference
    megatron/optimizer/__init__.py _get_params_for_weight_decay_optimization)."""
    out: dict = {}
    for path, _ in tree_leaves_with_path(params):
        keep = 0.0 if (any("norm" in str(k) for k in path)
                       or (path and str(path[-1]).startswith("b"))) else 1.0
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = keep
    return out


def _f32(x) -> float:
    """A host number rounded to fp32, as the JAX step computes it."""
    return float(np.float32(x))


def _leaves(params, grads, state: OptState):
    masters = state.master if state.master is not None else params
    return zip(tree_leaves(params), tree_leaves(masters), tree_leaves(grads),
               tree_leaves(state.mu),
               tree_leaves(state.nu) if state.nu is not None
               else [None] * len(tree_leaves(params)),
               tree_leaves(_wd_mask(params)))


def adamw_step(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
               state: OptState, lr: float, wd: float):
    """One AdamW update on the fp32 masters, in place; returns
    ``(params, state)`` with ``state.step`` advanced (FusedAdam's math)."""
    if state.nu is None:
        raise ValueError("adamw requires a second-moment tree")
    step = state.step + 1
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    c1 = _f32(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = _f32(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    with torch.no_grad():
        for p, m, g, mu, nu, wdm in _leaves(params, grads, state):
            g = g.float()
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu / c1).div_((nu / c2).sqrt_().add_(eps))
            if wd * wdm:
                update.add_(m, alpha=_f32(wd * wdm))
            m.add_(update, alpha=-lr)
            if m is not p:
                p.copy_(m)
    return params, state._replace(step=step)


def sgd_step(cfg: OptimizerConfig, params, grads, state: OptState, lr, wd):
    """Momentum SGD (reference optimizer choice 'sgd'), in place."""
    with torch.no_grad():
        for p, m, g, mu, _, wdm in _leaves(params, grads, state):
            g = g.float()
            if wd * wdm:
                g = g + _f32(wd * wdm) * m
            mu.mul_(cfg.sgd_momentum).add_(g)
            m.add_(mu, alpha=-lr)
            if m is not p:
                p.copy_(m)
    return params, state._replace(step=state.step + 1)


def optimizer_step(cfg: OptimizerConfig, params, grads, state, lr, wd):
    if cfg.optimizer == "adamw":
        return adamw_step(cfg, params, grads, state, lr, wd)
    if cfg.optimizer == "sgd":
        return sgd_step(cfg, params, grads, state, lr, wd)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def scaler_update(s: ScalerState, found_inf: bool,
                  cfg: OptimizerConfig) -> ScalerState:
    """Dynamic loss-scale growth/backoff (reference grad_scaler.py:86-106):
    on overflow the growth tracker resets and hysteresis counts down (back
    off at <= 0); hysteresis is restored only when the scale grows after a
    full clean window.  As in the JAX package, a hysteresis below 0 marks
    a constant scaler, so a dynamic one whose hysteresis counts down past
    0 stops moving (ROADMAP.md, Queue 3)."""
    is_constant = s.hysteresis < 0
    if found_inf:
        hysteresis = s.hysteresis - 1
        backoff = not is_constant and hysteresis <= 0
        scale = max(s.scale * 0.5, cfg.min_loss_scale) if backoff \
            else s.scale
        return ScalerState(scale, 0,
                           s.hysteresis if is_constant else hysteresis)
    growth = s.growth_tracker + 1
    if not is_constant and growth >= cfg.loss_scale_window:
        return ScalerState(s.scale * 2.0, 0, cfg.hysteresis)
    return ScalerState(s.scale, growth, s.hysteresis)
