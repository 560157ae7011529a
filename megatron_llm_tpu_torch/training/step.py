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

Under a ``ParallelPlan`` (data, tensor and sequence parallelism, ZeRO-1;
``make_plan``) the step runs inside the mesh (``parallel/mesh.use_mesh``)
on this rank's param shards and its dp block of each microbatch, and
after the accumulation writes out what GSPMD derives in JAX
(``reduce_grads``): the grads each tp rank holds in part are summed over
tp (``models/sharding.tp_partial_grads``), every grad is averaged over dp
(all-reduced, or reduce-scattered to the rank's ZeRO-1 block), and so is
the loss.  A rank's loss-mask count is not the global microbatch's, so
before the accumulation the step all-reduces each microbatch's count over
dp once (``loss_denominators``) and the losses divide by it, scaled so
that their mean over dp is the global masked mean.  The loss, the grad norm and so the guard's ``skip`` are then
the same on every rank, and every rank takes the same branch.

Pipeline parallelism (``pp > 1``) runs ``parallel/pipeline.pipeline_grads``
in place of the accumulation: this stage's chunks' grads, and its grads
of the embedding and head, which ``reduce_grads`` sums over pp.  A custom
loss runs its family's pipeline instead (``pipeline_loss_fn``:
``parallel/pipeline_encdec.py``), and without one raises as JAX's step
does.  Context parallelism (``cp > 1``) cuts each microbatch's sequence
to this rank's block (``context_parallel_block``; the zigzag layout
permutes it first, ``zigzag_permute_batch``) after the loss denominators
are counted over the whole sequence, so the grads and the loss are
summed over cp; inside the pipeline too (pp x cp), where each stage's
ring runs over its own cp group.  A custom loss's batch (the BERT, T5
and ICT losses) is not cut: every cp rank runs it whole and only the
ring splits the sequence (``ring_attention.whole_sequence``), as JAX's
step shards such a batch over dp alone, so its grads and loss are whole
on every cp rank and are not summed.  A MoE model adds
``moe_aux_loss_coeff`` times the aux loss to the loss (under cp each
rank's share of it, summed with the loss), and its routing stats to the
metrics (JAX ``step.py:145-150, 164-224``; not under pp, as in JAX).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..config import RuntimeConfig
from ..models import model as model_lib
from ..models.transformer import rope_tables
from ..ops import dropout as drop
from ..parallel import mappings, pipeline, ring_attention
from ..parallel.mesh import axis_info, use_mesh
from ..parallel.cross_entropy import (
    cross_entropy,
    fused_linear_cross_entropy,
    masked_mean_loss,
    vocab_parallel_cross_entropy,
)
from ..resilience.anomaly import GuardState, guard_update, init_guard_state
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import optimizer as opt_lib
from . import schedule

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: opt_lib.OptState
    iteration: int  # completed train steps, skipped ones included
    skipped: int    # anomalous steps skipped
    guard: GuardState


class ParallelPlan(NamedTuple):
    """What the step needs of the layout: the mesh, the param specs, the
    leaves whose grads each tp rank holds in part, and the ZeRO-1 plan
    (or None)."""

    mesh: Any
    specs: PyTree
    tp_partial: PyTree
    zero: Optional[opt_lib.Zero]


def make_plan(cfg: RuntimeConfig, mesh, specs: PyTree,
              params: PyTree) -> Optional[ParallelPlan]:
    """The plan of ``cfg.parallel`` on ``mesh`` for ``params`` (this
    rank's shards); None on a mesh of one rank, so a degree-1 run takes
    the one-device step unchanged."""
    from ..models.sharding import tp_partial_grads

    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return None
    partial = tp_partial_grads(specs, cfg.model.sequence_parallel_axis
                               is not None)
    return ParallelPlan(
        mesh=mesh, specs=specs,
        tp_partial=tree_map(lambda p, f: f, params, partial),
        zero=opt_lib.zero_plan(specs, params, cfg.parallel, mesh))


def reduce_grads(plan: ParallelPlan, grads: PyTree, loss: torch.Tensor,
                 cp_sum: bool = True):
    """``(grads, loss)`` of the whole model from this rank's: the tp-partial
    grads summed over tp, the leaves replicated over pp (the embedding
    and head) summed over pp, every grad and the loss summed over cp (not
    with ``cp_sum=False``: a custom loss's, whole on every cp rank), then
    averaged over dp (a ZeRO-1 leaf reduce-scattered to this rank's
    block)."""
    from ..models.sharding import has_axis

    mesh = plan.mesh
    tp_group, dp_group = mesh.group("tp"), mesh.group("dp")
    pp_group = mesh.group("pp")
    cp_group = mesh.group("cp") if cp_sum else None
    dp = mesh.size("dp")
    dims = [None] * len(tree_leaves(grads)) if plan.zero is None \
        else tree_leaves(plan.zero.dims)
    specs = tree_leaves(tree_map(lambda g, s: s, grads, plan.specs))
    out = []
    for g, partial, dim, spec in zip(tree_leaves(grads),
                                     tree_leaves(plan.tp_partial), dims,
                                     specs):
        if partial:
            mappings.all_reduce(g, tp_group)
        if pp_group is not None and not has_axis(spec, "pp"):
            mappings.all_reduce(g, pp_group)
        mappings.all_reduce(g, cp_group)
        if dp > 1:
            if dim is not None:
                g = mappings.reduce_scatter(g, dp_group, dim)
            else:
                mappings.all_reduce(g, dp_group)
            g.mul_(1.0 / dp)
        out.append(g)
    loss = mappings.all_reduce(loss.clone(), cp_group)
    if dp > 1:
        loss = mappings.all_reduce(loss.clone(), dp_group) * (1.0 / dp)
    return tree_unflatten(grads, out), loss


_SEQ_KEYS = ("tokens", "labels", "loss_mask", "segment_ids", "position_ids",
             "assistant_mask", "pad_mask")


def zigzag_permute_batch(cfg: RuntimeConfig, batch: dict) -> dict:
    """The zigzag cp layout (JAX ``zigzag_permute_batch``): the batch's
    sequence arrays permuted into chunk order ``[r, 2n-1-r]`` a cp rank,
    and RoPE handed the global positions.  Per-token CE, masked means and
    the registry metrics do not depend on the order.  Unchanged unless
    ``cfg.model.context_parallel_zigzag``."""
    if not cfg.model.context_parallel_zigzag:
        return batch
    from ..parallel.ring_attention import zigzag_indices

    tok = batch["tokens"]
    pi = torch.as_tensor(zigzag_indices(tok.shape[-1],
                                        cfg.parallel.context_parallel),
                         device=tok.device)
    out = dict(batch)
    for k in _SEQ_KEYS:
        if out.get(k) is not None:
            out[k] = out[k][..., pi]
    if batch.get("position_ids") is None:
        out["position_ids"] = pi.expand(tok.shape)
    return out


def context_parallel_block(cfg: RuntimeConfig, batch: dict, mesh) -> dict:
    """This cp rank's block of the batch's sequence (after the zigzag
    permutation where the layout is zigzag), with global position ids;
    the batch itself at cp = 1."""
    cp = 1 if mesh is None else mesh.size("cp")
    if cp == 1:
        return batch
    batch = zigzag_permute_batch(cfg, batch)
    tok = batch["tokens"]
    if batch.get("position_ids") is None:
        batch = dict(batch, position_ids=torch.arange(
            tok.shape[-1], device=tok.device).expand(tok.shape))
    n = tok.shape[-1] // cp
    lo = mesh.index("cp") * n
    return {k: v[..., lo:lo + n] if k in _SEQ_KEYS and v is not None else v
            for k, v in batch.items()}


def loss_denominators(batch: dict, dp_group, lead: int = 1,
                      whole: bool = False) -> dict:
    """``batch`` with ``loss_denom``: the loss-mask count of each
    microbatch over the dp group (clamped at 1, as the masked mean clamps
    it), divided by dp.  A rank's masked sum over it is its share of the
    global masked mean times dp, which the mean over dp undoes.  The
    first ``lead`` axes index microbatches (1 for ``[accum, micro, ...]``,
    0 for one microbatch); a batch without a loss mask is unchanged, and
    so is one at dp = 1 unless ``whole`` (the batch is about to be cut
    over cp: the count is the whole sequence's)."""
    dp = mappings.group_size(dp_group)
    if (dp == 1 and not whole) or "loss_mask" not in batch:
        return batch
    mask = batch["loss_mask"].to(torch.float32)
    count = mask.sum(dim=tuple(range(lead, mask.ndim)))
    count = mappings.all_reduce(count, dp_group)
    return dict(batch, loss_denom=torch.clamp(count, min=1.0) / dp)


def init_train_state(cfg: RuntimeConfig, params: PyTree,
                     zero: Optional[opt_lib.Zero] = None) -> TrainState:
    use_scaler = cfg.model.params_dtype in ("float16", "fp16")
    device = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt=opt_lib.init_opt_state(params, cfg.optimizer,
                                   use_fp16_scaler=use_scaler, zero=zero),
        iteration=0,
        skipped=0,
        guard=init_guard_state(device),
    )


def compute_loss(cfg: RuntimeConfig, params, batch: dict, rng=None,
                 rope=None, lora=None, return_moe_stats: bool = False):
    """Forward + masked LM loss for one microbatch: ``batch`` holds tokens,
    labels and a float loss_mask ``[b, s]``, optionally position_ids and
    segment_ids.  ``rng`` turns dropout on; ``lora`` (``(arenas, mask)``)
    adds the LoRA epilogues.  ``fused_lm_head`` takes the fused head over
    the ``b * s`` rows (JAX ``training/step.py:115-134``; not under tp or
    cp, where the plain head runs).  A MoE model's loss adds
    ``moe_aux_loss_coeff`` times its aux loss; ``return_moe_stats``
    returns ``(loss, stats)``, the stats summed over the layers."""
    kw = dict(position_ids=batch.get("position_ids"),
              segment_ids=batch.get("segment_ids"), rng=rng, rope=rope,
              lora=lora)
    tp = cfg.parallel.tensor_parallel
    if cfg.model.fused_lm_head and tp == 1 and \
            cfg.parallel.context_parallel == 1:
        hidden, moe_aux = model_lib.forward_hidden(cfg.model, params,
                                                   batch["tokens"], **kw)
        b, s, h = hidden.shape
        per_token = fused_linear_cross_entropy(
            hidden.reshape(b * s, h),
            model_lib.unembed_weight(cfg.model, params),
            batch["labels"].reshape(b * s),
            cfg.model.vocab_size).reshape(b, s)
    else:
        logits, moe_aux = model_lib.forward(cfg.model, params,
                                            batch["tokens"],
                                            return_aux=True, **kw)
        if tp > 1:  # this rank's vocabulary block of the logits
            per_token = vocab_parallel_cross_entropy(
                logits, batch["labels"], axis_info("tp")[0],
                vocab_size=cfg.model.vocab_size)
        else:
            per_token = cross_entropy(logits, batch["labels"],
                                      vocab_size=cfg.model.vocab_size)
    loss = masked_mean_loss(per_token, batch["loss_mask"],
                            batch.get("loss_denom"))
    if cfg.model.num_experts > 0:
        from ..models.moe import aux_loss_of

        loss = loss + cfg.model.moe_aux_loss_coeff * aux_loss_of(moe_aux)
    if return_moe_stats:
        return loss, moe_aux
    return loss


def _accumulate_grads(cfg: RuntimeConfig, params, batch: dict, rope,
                      loss_scale: float, loss_fn=None, rng=None,
                      return_moe_stats: bool = False):
    """``(fp32 grads, mean loss)`` over the ``[accum, micro_batch, ...]``
    batch; microbatch ``i`` gets ``rng`` folded with ``i``.
    ``loss_fn(cfg, params, microbatch, rng, deterministic)`` overrides the
    decoder-LM loss, as in JAX, with ``deterministic = rng is None`` (the
    reference's ``forward_step_func``: the BERT, T5 and ICT losses).  A
    MoE model's routing stats come back as a third value with
    ``return_moe_stats``: the per-layer mean over the microbatches (None
    for a dense model)."""
    accum = next(iter(batch.values())).shape[0]
    want_moe = loss_fn is None and cfg.model.num_experts > 0
    stats = None
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    grads = None
    loss_sum = None
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        mb_rng = None if rng is None else drop.fold_in(rng, i)
        if loss_fn is not None:
            loss = loss_fn(cfg, live, mb, mb_rng, mb_rng is None)
        elif want_moe:
            loss, mb_stats = compute_loss(cfg, live, mb, rng=mb_rng,
                                          rope=rope, return_moe_stats=True)
            mb_stats = {k: v.detach() for k, v in mb_stats.items()}
            stats = mb_stats if stats is None else \
                {k: stats[k] + mb_stats[k] for k in stats}
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
    if stats is not None:
        norm = 1.0 / (accum * cfg.model.num_layers)
        stats = {k: v * norm for k, v in stats.items()}
    if return_moe_stats:
        return tree_unflatten(params, grads), loss_sum, stats
    return tree_unflatten(params, grads), loss_sum


def step_grads(cfg: RuntimeConfig, params, batch: dict, rope,
               loss_scale: float = 1.0, loss_fn=None, rng=None,
               plan: Optional[ParallelPlan] = None, pipeline_loss_fn=None):
    """A step's ``(grads, loss, moe_stats)`` before the optimizer: the
    batch's loss denominators and cp block under ``plan``, the pipeline
    (pp > 1; a custom loss's ``pipeline_loss_fn``) or the microbatch
    accumulation, and the plan's reductions (``moe_stats`` None under pp,
    as in JAX)."""
    custom = loss_fn is not None
    if custom and cfg.model.context_parallel_zigzag:
        # JAX step.py:281-285: the zigzag permutation is the LM loss's
        raise NotImplementedError(
            "custom loss_fn is not supported with the zigzag cp layout")
    moe_stats = None
    whole_cp = False
    if plan is not None:
        cp = plan.mesh.size("cp")
        whole_cp = custom and cp > 1
        batch = loss_denominators(batch, plan.mesh.group("dp"),
                                  whole=cp > 1 and not custom)
        if not custom:
            batch = context_parallel_block(cfg, batch, plan.mesh)
    with ring_attention.whole_sequence(whole_cp):
        if cfg.parallel.pipeline_parallel > 1 and custom:
            if pipeline_loss_fn is None:
                # JAX step.py:276-280
                raise NotImplementedError(
                    "custom loss_fn is not supported with pipeline "
                    "parallelism (pass pipeline_loss_fn for the encdec "
                    "families)")
            grads, loss = pipeline_loss_fn(cfg, params, batch, rng=rng,
                                           loss_scale=loss_scale)
        elif cfg.parallel.pipeline_parallel > 1:
            grads, loss, aux, _ = pipeline.pipeline_grads(
                cfg, params, batch, rng=rng, rope=rope,
                loss_scale=loss_scale)
            loss = loss + pipeline.aux_term(cfg, aux,
                                             batch["tokens"].shape[0])
        else:
            grads, loss, moe_stats = _accumulate_grads(
                cfg, params, batch, rope, loss_scale, loss_fn, rng,
                return_moe_stats=True)
    if plan is not None:
        grads, loss = reduce_grads(plan, grads, loss, cp_sum=not whole_cp)
    return grads, loss, moe_stats


def train_step(cfg: RuntimeConfig, state: TrainState, batch: dict,
               base_rng=None, rope=None, loss_fn=None,
               plan: Optional[ParallelPlan] = None, pipeline_loss_fn=None):
    """One optimizer step over the batch's microbatches → ``(new_state,
    metrics)``.  Params and optimizer state are updated in place.
    ``base_rng`` (a ``DropoutKey``) is folded with the iteration.  Under
    ``plan`` the batch is this rank's dp block and the step runs on the
    current mesh."""
    scaler = state.opt.scaler
    loss_scale = scaler.scale if scaler is not None else 1.0
    rng = None if base_rng is None else drop.fold_in(base_rng,
                                                     state.iteration)
    grads, loss, moe_stats = step_grads(cfg, state.params, batch, rope,
                                        loss_scale, loss_fn, rng, plan,
                                        pipeline_loss_fn)
    if loss_scale != 1.0:
        for g in tree_leaves(grads):
            g.div_(loss_scale)
    grad_norm = opt_lib.global_grad_norm(grads, plan)
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
        params, opt = opt_lib.optimizer_step(
            cfg.optimizer, params, grads, opt, lr, wd,
            None if plan is None else plan.zero)
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
    if moe_stats is not None:
        # dropped: the fraction of assignments lost to capacity;
        # imbalance: E * max(f_e), 1.0 when balanced (JAX step.py:373-383)
        aux = moe_stats["aux"]
        if plan is not None:
            # a cp rank's aux is its share; each dp rank's takes its own
            # p_e (models/moe.py)
            aux = mappings.all_reduce(aux.clone(), plan.mesh.group("cp"))
            if plan.mesh.size("dp") > 1:
                aux = mappings.all_reduce(aux.clone(),
                                          plan.mesh.group("dp")) \
                    / plan.mesh.size("dp")
        load = moe_stats["load"]
        metrics["moe_dropped_frac"] = moe_stats["dropped"]
        metrics["moe_load_imbalance"] = (
            cfg.model.num_experts * load.max()
            / torch.clamp(load.sum(), min=1e-9))
        metrics["moe_aux_loss"] = aux
    return new_state, metrics


def make_train_step(cfg: RuntimeConfig, device=None, loss_fn=None,
                    plan: Optional[ParallelPlan] = None,
                    pipeline_loss_fn=None):
    """``step(state, batch, base_rng=None) -> (state, metrics)`` with the
    RoPE tables built once on ``device`` (default ``cuda``) and closed
    over, as the JAX step closes over them as constants.  Under ``plan``
    each call runs inside its mesh.  ``pipeline_loss_fn`` (a custom
    loss's pipeline, ``parallel/pipeline_encdec.py``) gives the grads at
    pp > 1."""
    device = model_lib.default_device(device)
    rope = rope_tables(cfg.model, device=device)

    def step(state: TrainState, batch: dict, base_rng=None):
        if plan is None:
            return train_step(cfg, state, batch, base_rng, rope=rope,
                              loss_fn=loss_fn,
                              pipeline_loss_fn=pipeline_loss_fn)
        with use_mesh(plan.mesh):
            return train_step(cfg, state, batch, base_rng, rope=rope,
                              loss_fn=loss_fn, plan=plan,
                              pipeline_loss_fn=pipeline_loss_fn)

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

