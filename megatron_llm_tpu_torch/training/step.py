"""The train step: forward and backward over the microbatches, fp32 grad
accumulation, unscale, clip, the anomaly guard and the optimizer update
(mirror of ``megatron_llm_tpu/training/step.py``; reference
megatron/training.py:393-459 ``train_step``).

Per microbatch, autograd gives each param's grad in the param's dtype; it
is cast to fp32 and summed (a single microbatch is cast once), then the
sum is divided by the microbatch count.  Then: unscale → global norm →
guard → clip → lr and wd from the schedule at ``opt.step`` (successful
updates only) → the in-place optimizer update.  An anomalous step
(non-finite grads or loss, or a loss spike) is decided on the host (the
step's one synchronization) and leaves params and optimizer state bitwise
untouched; only the guard, the counters and the loss scaler move.

Dropout follows JAX's key chain: the step folds ``base_rng`` with the
iteration and each microbatch's key with its index; without a key the
step is deterministic.  With ``fused_lm_head`` the loss streams the head
over vocabulary blocks (``fused_linear_cross_entropy``) and never holds
the ``[b, s, vocab]`` fp32 logits.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import RuntimeConfig
from ..models import model as model_lib
from ..models.transformer import rope_tables
from ..ops import dropout as drop
from ..parallel.cross_entropy import (
    cross_entropy,
    fused_linear_cross_entropy,
    masked_mean_loss,
)
from ..resilience.anomaly import GuardState, guard_update, init_guard_state
from ..utils.tree import tree_leaves, tree_unflatten
from . import optimizer as opt_lib
from . import schedule

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: opt_lib.OptState
    iteration: int  # completed train steps, skipped ones included
    skipped: int    # anomalous steps skipped
    guard: GuardState


def init_train_state(cfg: RuntimeConfig, params: PyTree) -> TrainState:
    use_scaler = cfg.model.params_dtype in ("float16", "fp16")
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt=opt_lib.init_opt_state(params, cfg.optimizer,
                                   use_fp16_scaler=use_scaler),
        iteration=0,
        skipped=0,
        guard=init_guard_state(device),
    )


def compute_loss(cfg: RuntimeConfig, params, batch: dict, rng=None,
                 rope=None, lora=None):
    """Forward + masked LM loss for one microbatch: ``batch`` holds tokens,
    labels and a float loss_mask ``[b, s]``, optionally position_ids and
    segment_ids.  ``rng`` turns dropout on; ``lora`` (``(arenas, mask)``)
    adds the LoRA epilogues.  ``fused_lm_head`` takes the fused head over
    the ``b * s`` rows (JAX ``training/step.py:115-134``; tp and cp are
    refused by ``RuntimeConfig.validate``)."""
    kw = dict(position_ids=batch.get("position_ids"),
              segment_ids=batch.get("segment_ids"), rng=rng, rope=rope,
              lora=lora)
    if cfg.model.fused_lm_head:
        hidden, _ = model_lib.forward_hidden(cfg.model, params,
                                             batch["tokens"], **kw)
        b, s, h = hidden.shape
        per_token = fused_linear_cross_entropy(
            hidden.reshape(b * s, h),
            model_lib.unembed_weight(cfg.model, params),
            batch["labels"].reshape(b * s),
            cfg.model.vocab_size).reshape(b, s)
    else:
        logits, _ = model_lib.forward(cfg.model, params, batch["tokens"],
                                      return_aux=True, **kw)
        per_token = cross_entropy(logits, batch["labels"],
                                  vocab_size=cfg.model.vocab_size)
    return masked_mean_loss(per_token, batch["loss_mask"])


def _accumulate_grads(cfg: RuntimeConfig, params, batch: dict, rope,
                      loss_scale: float, loss_fn=None, rng=None):
    """``(fp32 grads, mean loss)`` over the ``[accum, micro_batch, ...]``
    batch; microbatch ``i`` gets ``rng`` folded with ``i``.
    ``loss_fn(cfg, params, microbatch, rng, deterministic)`` overrides the
    decoder-LM loss, as in JAX, with ``deterministic = rng is None`` (the
    reference's ``forward_step_func``: the BERT, T5 and ICT losses)."""
    accum = next(iter(batch.values())).shape[0]
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    grads = None
    loss_sum = None
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        mb_rng = None if rng is None else drop.fold_in(rng, i)
        if loss_fn is not None:
            loss = loss_fn(cfg, live, mb, mb_rng, mb_rng is None)
        else:
            loss = compute_loss(cfg, live, mb, rng=mb_rng, rope=rope)
        # under a custom loss, a leaf it does not reach (the pooler under
        # mean pooling) has JAX's zero grad; the decoder-LM loss reaches
        # every leaf, so one cut off there is a fault and raises
        step_grads = torch.autograd.grad(loss * loss_scale, leaves,
                                         allow_unused=loss_fn is not None)
        if grads is None:  # the first cast copies, the rest add in place
            grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                     else g.to(torch.float32, copy=True)
                     for p, g in zip(leaves, step_grads)]
        else:
            for acc, g in zip(grads, step_grads):
                if g is not None:
                    acc.add_(g)
        del step_grads
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    if accum > 1:
        inv = 1.0 / accum
        for g in grads:
            g.mul_(inv)
        loss_sum = loss_sum * inv
    return tree_unflatten(params, grads), loss_sum


def train_step(cfg: RuntimeConfig, state: TrainState, batch: dict,
               base_rng=None, rope=None, loss_fn=None):
    """One optimizer step over the batch's microbatches → ``(new_state,
    metrics)``.  Params and optimizer state are updated in place.
    ``base_rng`` (a ``DropoutKey``) is folded with the iteration."""
    scaler = state.opt.scaler
    loss_scale = scaler.scale if scaler is not None else 1.0
    rng = None if base_rng is None else drop.fold_in(base_rng,
                                                     state.iteration)
    grads, loss = _accumulate_grads(cfg, state.params, batch, rope,
                                    loss_scale, loss_fn, rng)
    if loss_scale != 1.0:
        for g in tree_leaves(grads):
            g.div_(loss_scale)
    grad_norm = opt_lib.global_grad_norm(grads)
    found_inf = ~torch.isfinite(grad_norm)
    guard, anomalous, data_anomaly = guard_update(
        state.guard, loss, found_inf,
        z_threshold=cfg.train.anomaly_z_threshold,
        alpha=cfg.train.anomaly_ewma_alpha,
        warmup_steps=cfg.train.anomaly_warmup_steps)
    skip = bool(anomalous)  # the step's one host synchronization

    train_iters = cfg.train.train_iters
    lr = schedule.learning_rate(cfg.optimizer, state.opt.step, train_iters)
    wd = schedule.weight_decay(cfg.optimizer, state.opt.step, train_iters)
    params, opt = state.params, state.opt
    if not skip:
        if cfg.optimizer.clip_grad > 0:
            opt_lib.clip_by_global_norm(grads, cfg.optimizer.clip_grad,
                                        norm=grad_norm)
        params, opt = opt_lib.optimizer_step(cfg.optimizer, params, grads,
                                             opt, lr, wd)
    del grads
    if scaler is not None:
        # the scaler reacts to overflow only, not to a data anomaly
        opt = opt._replace(scaler=opt_lib.scaler_update(
            scaler, bool(found_inf), cfg.optimizer))
    new_state = TrainState(params=params, opt=opt,
                           iteration=state.iteration + 1,
                           skipped=state.skipped + int(skip), guard=guard)
    metrics = {
        "loss": loss,
        "grad_norm": grad_norm,
        "lr": lr,
        "weight_decay": wd,
        "skipped": int(skip),
        "anomaly": data_anomaly.to(torch.int32),
        "anomaly_run": guard.run,
        "loss_scale": loss_scale,
    }
    return new_state, metrics


def make_train_step(cfg: RuntimeConfig, device=None, loss_fn=None):
    """``step(state, batch, base_rng=None) -> (state, metrics)`` with the
    RoPE tables built once on ``device`` (default ``cuda``) and closed
    over, as the JAX step closes over them as constants."""
    device = model_lib.default_device(device)
    rope = rope_tables(cfg.model, device=device)

    def step(state: TrainState, batch: dict, base_rng=None):
        return train_step(cfg, state, batch, base_rng, rope=rope,
                          loss_fn=loss_fn)

    return step


def to_device_batch(batch: dict, device) -> dict:
    """numpy ``[accum, micro, ...]`` batch → tensors on ``device``: the
    loss mask and any float array (a custom loss's masks) as fp32, the rest
    (token ids, labels) as int64 for indexing, as JAX's ``jnp.asarray``
    keeps each kind."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.float() if k == "loss_mask" or t.is_floating_point() \
            else t.long()
        out[k] = t.to(device, non_blocking=True)
    return out

