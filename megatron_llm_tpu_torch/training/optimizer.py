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
activations.

ZeRO-1 (JAX ``zero1_specs`` / ``opt_state_specs``, reference
distrib_optimizer.py): each ``mu``, ``nu`` and ``master`` leaf is split
over dp on the first dimension that the param's spec leaves unsplit and
dp divides; a leaf with no such dimension stays whole.  A ``Zero`` plan
carries those dimensions and the dp group: ``init_opt_state`` keeps this
rank's block of each split leaf, the step hands the update this rank's
block of the grad (reduce-scattered), and the update all-gathers the new
params over dp.  Under a mesh ``global_grad_norm`` and ``count_zeros``
count each leaf once: a tp-sharded leaf's blocks summed over tp, a
ZeRO-split grad's blocks over dp, a replicated leaf as it is.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..config import OptimizerConfig, ParallelConfig
from ..parallel import mappings
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


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state split over dp
# ---------------------------------------------------------------------------


class Zero(NamedTuple):
    """A ZeRO-1 plan: each leaf's optimizer-state spec (``zero1_specs``)
    and split dimension (or None), and the dp group, its size and this
    rank's index on it."""

    specs: PyTree
    dims: PyTree
    group: Any
    size: int
    index: int


def zero1_specs(param_specs: PyTree, params: PyTree,
                parallel: ParallelConfig) -> PyTree:
    """Each spec with ``"dp"`` on the first dimension the spec leaves
    unsplit and dp divides (JAX ``zero1_specs``); the spec itself where
    there is none, or without ZeRO-1.  ``params`` may be this rank's
    blocks: an unsplit dimension is the same size in both."""
    dp = parallel.data_parallel
    if dp <= 1 or not parallel.use_distributed_optimizer:
        return param_specs

    def add_dp(p, spec):
        parts = list(spec) + [None] * (p.ndim - len(spec))
        for i, (axis, dim) in enumerate(zip(parts, p.shape)):
            if axis is None and dim % dp == 0:
                parts[i] = "dp"
                return tuple(parts)
        return spec

    return tree_map(add_dp, params, param_specs)


def opt_state_specs(param_specs: PyTree, params: PyTree,
                    parallel: ParallelConfig, state: "OptState") -> "OptState":
    """The spec tree of an ``OptState`` (checkpoints)."""
    leaf_specs = zero1_specs(param_specs, params, parallel)
    scaler = None if state.scaler is None else ScalerState((), (), ())
    return OptState(
        step=(), mu=leaf_specs,
        nu=leaf_specs if state.nu is not None else None,
        master=leaf_specs if state.master is not None else None,
        scaler=scaler)


def zero_plan(param_specs: PyTree, params: PyTree, parallel: ParallelConfig,
              mesh) -> Optional[Zero]:
    """The ``Zero`` plan of ``parallel`` on ``mesh``, or None without
    ZeRO-1 (or at dp = 1)."""
    if parallel.data_parallel <= 1 or not parallel.use_distributed_optimizer:
        return None
    specs = zero1_specs(param_specs, params, parallel)
    dims = tree_map(lambda s: s.index("dp") if "dp" in s else None, specs)
    return Zero(specs, dims, mesh.group("dp"), mesh.size("dp"),
                mesh.index("dp"))


def _zero_dims(zero: Optional[Zero], params) -> list:
    if zero is None:
        return [None] * len(tree_leaves(params))
    return tree_leaves(zero.dims)


def zero_block(t: torch.Tensor, dim: Optional[int], zero: Zero):
    """This rank's dp block of ``t`` along ``dim`` (a view)."""
    if dim is None:
        return t
    n = t.shape[dim] // zero.size
    return t.narrow(dim, zero.index * n, n)


def init_opt_state(params: PyTree, cfg: OptimizerConfig,
                   use_fp16_scaler: bool = False,
                   zero: Optional[Zero] = None) -> OptState:
    dims = iter(_zero_dims(zero, params))

    def block(p):
        return zero_block(p, next(dims), zero)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    blocks = tree_map(block, params)
    master = None
    if _needs_master(params):
        # a copy even of an fp32 leaf, so master and param never alias
        master = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), blocks)
    params = blocks
    scaler = init_dynamic_scaler(cfg) if use_fp16_scaler else init_scaler(cfg)
    return OptState(
        step=0,
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params) if cfg.optimizer == "adamw" else None,
        master=master,
        scaler=scaler,
    )


def _mesh_sum(values: list, grads, plan) -> torch.Tensor:
    """The sum over the mesh of per-leaf numbers counting each leaf once:
    a leaf's blocks summed over each axis that splits it (tp, pp, ep in
    its spec; dp where ZeRO-1 splits its grad), a replicated leaf counted
    once (``plan``: a ``training.step.ParallelPlan``).  One all-reduce an
    axis of size above 1."""
    from ..models.sharding import has_axis

    mesh = plan.mesh
    axes = [a for a in ("dp", "ep", "pp", "tp") if mesh.size(a) > 1]
    specs = tree_leaves(tree_map(lambda g, spec: spec, grads, plan.specs))
    zero_split = [d is not None for d in _zero_dims(plan.zero, grads)]
    by: dict = {}
    for v, spec, z in zip(values, specs, zero_split):
        key = frozenset(a for a in axes if (a == "dp" and z) or (
            a != "dp" and has_axis(spec, a)))
        by[key] = by[key] + v if key in by else v
    for a in axes:  # the same order on every rank: the specs agree
        keys = sorted((k for k in by if a in k), key=sorted)
        if not keys:
            continue
        summed = mappings.all_reduce(torch.stack([by.pop(k) for k in keys]),
                                     mesh.group(a))
        for k, v in zip(keys, summed):
            k2 = k - {a}
            by[k2] = by[k2] + v if k2 in by else v
    total = values[0] * 0
    for k in sorted(by, key=sorted):
        total = total + by[k]
    return total


def global_grad_norm(grads: PyTree, plan=None) -> torch.Tensor:
    """One L2 norm over every grad leaf (fp32, a 0-d tensor); under a
    ``plan`` the norm of the whole model's grads."""
    if plan is None:
        norms = [torch.linalg.vector_norm(g.float())
                 for g in tree_leaves(grads)]
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = [torch.linalg.vector_norm(g.float()).square()
          for g in tree_leaves(grads)]
    return torch.sqrt(_mesh_sum(sq, grads, plan))


def clip_by_global_norm(grads: PyTree, max_norm: float, norm=None):
    """Scale the grads IN PLACE so their global norm is at most
    ``max_norm``; returns ``(grads, norm)``."""
    if norm is None:
        norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(factor.to(g.dtype))
    return grads, norm


def count_zeros(grads: PyTree, plan=None) -> torch.Tensor:
    """Zero-grad diagnostic (reference clip_grads.py:110-136); under a
    ``plan`` the count over the whole model."""
    counts = [torch.sum(g == 0) for g in tree_leaves(grads)]
    if plan is None:
        return torch.stack(counts).sum()
    return _mesh_sum(counts, grads, plan)


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


def _leaves(params, grads, state: OptState, zero: Optional[Zero] = None):
    """Per leaf ``(param, master block, grad block, mu, nu, wd mask, ZeRO
    dim)``; without a master (fp32 params) the master block is a view of
    the param."""
    dims = _zero_dims(zero, params)
    masters = tree_leaves(state.master) if state.master is not None else [
        zero_block(p, d, zero) for p, d in zip(tree_leaves(params), dims)]
    return zip(tree_leaves(params), masters, tree_leaves(grads),
               tree_leaves(state.mu),
               tree_leaves(state.nu) if state.nu is not None
               else [None] * len(tree_leaves(params)),
               tree_leaves(_wd_mask(params)), dims)


def _publish(p: torch.Tensor, m: torch.Tensor, dim, zero) -> None:
    """The param from its updated master (block): cast, and all-gathered
    over dp under ZeRO-1."""
    if dim is not None:
        p.copy_(mappings.all_gather(m.to(p.dtype), zero.group, dim))
    elif m is not p:
        p.copy_(m)


def adamw_step(cfg: OptimizerConfig, params: PyTree, grads: PyTree,
               state: OptState, lr: float, wd: float,
               zero: Optional[Zero] = None):
    """One AdamW update on the fp32 masters, in place; returns
    ``(params, state)`` with ``state.step`` advanced (FusedAdam's math).
    Under ``zero`` each split leaf's grad, moments and master are this
    rank's dp block."""
    if state.nu is None:
        raise ValueError("adamw requires a second-moment tree")
    step = state.step + 1
    b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
    c1 = _f32(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = _f32(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    with torch.no_grad():
        for p, m, g, mu, nu, wdm, dim in _leaves(params, grads, state,
                                                  zero):
            g = g.float()
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (mu / c1).div_((nu / c2).sqrt_().add_(eps))
            if wd * wdm:
                update.add_(m, alpha=_f32(wd * wdm))
            m.add_(update, alpha=-lr)
            _publish(p, m, dim, zero)
    return params, state._replace(step=step)


def sgd_step(cfg: OptimizerConfig, params, grads, state: OptState, lr, wd,
             zero: Optional[Zero] = None):
    """Momentum SGD (reference optimizer choice 'sgd'), in place."""
    with torch.no_grad():
        for p, m, g, mu, _, wdm, dim in _leaves(params, grads, state, zero):
            g = g.float()
            if wd * wdm:
                g = g + _f32(wd * wdm) * m
            mu.mul_(cfg.sgd_momentum).add_(g)
            m.add_(mu, alpha=-lr)
            _publish(p, m, dim, zero)
    return params, state._replace(step=state.step + 1)


def optimizer_step(cfg: OptimizerConfig, params, grads, state, lr, wd,
                   zero: Optional[Zero] = None):
    if cfg.optimizer == "adamw":
        return adamw_step(cfg, params, grads, state, lr, wd, zero)
    if cfg.optimizer == "sgd":
        return sgd_step(cfg, params, grads, state, lr, wd, zero)
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
