"""Pipeline parallelism over the ``pp`` axis: 1F1B and interleaved 1F1B,
written out (mirror of ``megatron_llm_tpu/parallel/pipeline.py``;
reference megatron/schedules.py:253-722).

JAX writes the pipeline as one SPMD scan of ticks whose ``jax.grad`` is
the backward pipeline.  Torch has no such transform, so the schedule is
written out as the reference writes it: each stage runs each
microbatch's forward, and later its backward (``torch.autograd.grad`` of
the stage's output against the grad its successor sent), accumulating
fp32 grads per microbatch as ``training/step._accumulate_grads`` does.

The layout is JAX's, leaf for leaf: the layer stack ``[L, ...]`` becomes
``[vpp, pp, lpc, ...]`` (``to_stage_layers``), split over ``pp`` on its
second axis (``stage_layer_specs``), so chunk ``v`` on stage ``s`` holds
global layers ``[(v * pp + s) * lpc, (v * pp + s + 1) * lpc)``.  The
embedding, the final norm and the LM head stay replicated over ``pp``;
each stage's grads of them (zeros on a stage that does not use them)
are summed over the pp group by the step (``training/step.reduce_grads``),
the cotangent sum JAX's ``shard_map`` transpose does.

The schedule (``build_schedule``): every stage's action list is the
reference's, warmup forwards, then one forward and one backward in
turn, then the cooldown backwards:

- ``vpp = 1``: 1F1B (schedules.py:606-722), ``pp - stage - 1`` warmup
  forwards;
- ``vpp > 1`` and ``M % pp == 0``: the interleaved schedule
  (schedules.py:253) in JAX's group order (``tight_indices``):
  microbatches in groups of ``pp``, each group through every chunk;
- ``vpp > 1`` and ``M % pp != 0`` (JAX's legacy order, which the
  reference refuses): the same group order with a short last group, every
  forward before the first backward.

The stages run in lockstep steps: in each step every stage takes the
next action of its list whose input has arrived, then the outputs move
one stage on and the input grads one stage back, each as one
``mappings.ppermute`` over the pp group of the pairs that send.  Every
rank derives the same steps from ``(pp, vpp, M)``, so a receiver knows
what arrives.  A stage holds at most about ``pp`` microbatches' forwards
awaiting their backward (``max_in_flight``): less than JAX's scan, which
keeps ``M * vpp + pp - 1`` boundary tensors.

Carried over from JAX: stage 0 embeds a microbatch when it enters chunk
0; the last stage runs norm → unembed → CE on each finished microbatch
(the streamed head) with the global masked-mean denominators; the loss
is the mean over microbatches; ``return_stats`` gives the per-token loss
and correctness for the registry metrics; the MoE aux sums count every
(stage, chunk, microbatch) once and no bubble; the dropout keys are
folded per (microbatch, ring position ``chunk * pp + stage``), with the
global layer offset for the LIMA and drop-path ramps.

Under context parallelism (pp x cp, the contiguous layout) each rank
runs its block of every microbatch's sequence, with global position ids
(the step cuts the batch, ``training/step.context_parallel_block``), and
attention's ring runs over the stage's own cp group; the head's loss is
this rank's share of the masked mean (the denominators count the whole
sequence), which the step sums over cp, as JAX's ``cp_sum`` does, and a
MoE aux is a cp shard's, its mean over cp JAX's.  ``run_lockstep`` is
the loop of the steps, shared with the encoder families' pipeline
(``parallel/pipeline_encdec.py``).
"""

from __future__ import annotations

import time
from typing import Any

import torch

from ..config import ModelConfig, RuntimeConfig
from ..models import model as model_lib
from ..models.transformer import AttnSideInputs, rope_tables, stack_forward
from ..ops import dropout as drop
from ..ops.norms import norm_apply
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import mappings
from . import mesh as mesh_lib
from .cross_entropy import cross_entropy, masked_mean_loss, \
    vocab_parallel_cross_entropy

PyTree = Any
PP = mesh_lib.PIPELINE_AXIS

# seconds each stage spent in the pipeline's ppermutes (the last call's;
# the stage's wait for its peers included)
last_p2p_seconds = [0.0]


# ---------------------------------------------------------------------------
# The stage-stacked parameter layout
# ---------------------------------------------------------------------------


def layers_per_chunk(num_layers: int, pp: int, vpp: int = 1) -> int:
    return mesh_lib.pipeline_stage_layers(num_layers, pp, vpp)[0]


def to_stage_layers(stacked: PyTree, pp: int, vpp: int = 1) -> PyTree:
    """``[L, ...]`` layer stack → the ``[vpp, pp, lpc, ...]`` layout."""
    def split(x):
        lpc = layers_per_chunk(x.shape[0], pp, vpp)
        return x.reshape((vpp, pp, lpc) + tuple(x.shape[1:]))

    return tree_map(split, stacked)


def from_stage_layers(staged: PyTree) -> PyTree:
    """The inverse of ``to_stage_layers`` (checkpoints, HF interop)."""
    return tree_map(lambda x: x.reshape(
        (x.shape[0] * x.shape[1] * x.shape[2],) + tuple(x.shape[3:])),
        staged)


def to_pipeline_params(params: PyTree, parallel) -> PyTree:
    """Model params with the layer stack in the pipeline layout."""
    if parallel.pipeline_parallel == 1:
        return params
    out = dict(params)
    out["layers"] = to_stage_layers(params["layers"],
                                    parallel.pipeline_parallel,
                                    parallel.virtual_pipeline_stages)
    return out


def from_pipeline_params(params: PyTree, parallel) -> PyTree:
    if parallel.pipeline_parallel == 1:
        return params
    out = dict(params)
    out["layers"] = from_stage_layers(params["layers"])
    return out


def stage_layer_specs(layer_specs: PyTree) -> PyTree:
    """Per-layer-stack specs ``(None, *dims)`` → staged specs ``(None,
    "pp", None, *dims)``."""
    return tree_map(lambda s: (None, PP, None) + tuple(s)[1:], layer_specs)


def pipeline_param_specs(specs: PyTree, parallel) -> PyTree:
    """The model's spec tree with the layer stack staged over ``pp``."""
    if parallel.pipeline_parallel == 1:
        return specs
    out = dict(specs)
    out["layers"] = stage_layer_specs(specs["layers"])
    return out


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


def tight_indices(rel, pp: int, vpp: int):
    """``(microbatch, chunk)`` of the ``rel``-th forward of a stage in the
    group-interleaved order: microbatches in groups of ``pp``, each group
    through every chunk (JAX's, the reference's interleaved order)."""
    g = rel // pp
    return (g // vpp) * pp + rel % pp, g % vpp


def _forward_order(pp: int, vpp: int, M: int) -> list:
    """Every stage's ``(m, c)`` forwards in order: ``tight_indices`` over
    the whole groups of ``pp`` microbatches, then (the legacy case,
    ``M % pp``) the short last group through every chunk."""
    whole = M - M % pp
    order = [tight_indices(rel, pp, vpp) for rel in range(whole * vpp)]
    return order + [(m, c) for c in range(vpp) for m in range(whole, M)]


def _stage_actions(pp: int, vpp: int, M: int, stage: int,
                   backward: bool) -> list:
    fwd = [("F", m, c) for m, c in _forward_order(pp, vpp, M)]
    if not backward:
        return fwd
    bwd = [("B", m, vpp - 1 - c) for _, m, c in fwd]
    total = len(fwd)
    if vpp == 1:
        warm = min(pp - stage - 1, M)
    elif M % pp:                      # the legacy order: all forwards first
        warm = total
    elif M == pp:
        warm = total
    else:
        warm = min((pp - stage - 1) * 2 + (vpp - 1) * pp, total)
    out = fwd[:warm]
    for k in range(total - warm):
        out += [fwd[warm + k], bwd[k]]
    return out + bwd[total - warm:]


def next_position(stage: int, chunk: int, pp: int, vpp: int):
    """Where a forward's output goes: ``(stage, chunk)`` of the next ring
    position, or None after the last chunk of the last stage."""
    if stage < pp - 1:
        return stage + 1, chunk
    return (0, chunk + 1) if chunk < vpp - 1 else None


def prev_position(stage: int, chunk: int, pp: int, vpp: int):
    """Where a backward's input grad goes, or None at chunk 0 of stage 0
    (the embedding takes it there)."""
    if stage > 0:
        return stage - 1, chunk
    return (pp - 1, chunk - 1) if chunk > 0 else None


def build_schedule(pp: int, vpp: int, M: int,
                   backward: bool = True) -> list:
    """The lockstep steps: each a list over stages of None or an action
    ``("F" | "B", microbatch, chunk)``.  A stage takes its next action
    once its input has arrived (sent in an earlier step); a step where no
    stage can act would be a deadlock, and raises."""
    if vpp > 1 and M < pp:
        raise ValueError(f"the interleaved pipeline needs "
                         f"num_microbatches >= pp ({M} < {pp})")
    lists = [_stage_actions(pp, vpp, M, s, backward) for s in range(pp)]
    ptr = [0] * pp
    fwd_at, grad_at, done_f = {}, {}, {}
    steps = []
    t = 0
    while any(p < len(a) for p, a in zip(ptr, lists)):
        row = [None] * pp
        for s in range(pp):
            if ptr[s] == len(lists[s]):
                continue
            kind, m, c = lists[s][ptr[s]]
            if kind == "F":
                ready = (s == 0 and c == 0) or fwd_at.get((s, m, c), t + 1) \
                    <= t
            else:
                ready = done_f.get((s, m, c), t) < t and (
                    next_position(s, c, pp, vpp) is None
                    or grad_at.get((s, m, c), t + 1) <= t)
            if ready:
                row[s] = (kind, m, c)
                ptr[s] += 1
        if all(a is None for a in row):
            raise RuntimeError(f"pipeline schedule deadlock at step {t} "
                               f"(pp {pp}, vpp {vpp}, M {M})")
        for s, a in enumerate(row):
            if a is None:
                continue
            kind, m, c = a
            if kind == "F":
                done_f[(s, m, c)] = t
                nxt = next_position(s, c, pp, vpp)
                if nxt is not None:
                    fwd_at[(nxt[0], m, nxt[1])] = t + 1
            else:
                prv = prev_position(s, c, pp, vpp)
                if prv is not None:
                    grad_at[(prv[0], m, prv[1])] = t + 1
        steps.append(row)
        t += 1
    return steps


def max_in_flight(pp: int, vpp: int, M: int) -> list:
    """Each stage's most forwards awaiting their backward at once."""
    live = [0] * pp
    most = [0] * pp
    for row in build_schedule(pp, vpp, M):
        for s, a in enumerate(row):
            if a is not None:
                live[s] += 1 if a[0] == "F" else -1
                most[s] = max(most[s], live[s])
    return most


# ---------------------------------------------------------------------------
# Memory model and the remat window
# ---------------------------------------------------------------------------


def _recompute_cost(cfg: ModelConfig, recompute: str) -> float:
    """Saved values a layer keeps per boundary tensor (JAX's
    coefficients)."""
    return {"full": 1.0,
            "selective": 4.0,
            "none": 4.0 + 3.0 * cfg.ffn_size / cfg.hidden_size}[recompute]


def _saved_per_layer(cfg: ModelConfig, recompute: str) -> float:
    """What a layer of the port keeps for its backward, in boundary
    tensors ``[mb, s, h]``: under ``"full"`` its input; under
    ``"selective"`` its input and the projections' outputs the policy
    saves (q, k, v, wo; gate and up, or up; down); under ``"none"``
    JAX's coefficient."""
    if recompute != "selective":
        return _recompute_cost(cfg, recompute)
    h, d = cfg.hidden_size, cfg.head_dim
    qkv = (cfg.num_attention_heads + 2 * cfg.kv_heads) * d / h
    mlp = (2.0 if cfg.is_glu else 1.0) * cfg.ffn_size / h
    return 1.0 + qkv + 1.0 + mlp + 1.0


def auto_remat_window(cfg: ModelConfig, *, pp: int, vpp: int, M: int) -> int:
    """JAX's memory-minimizing window of its tick-scan remat
    (``pipeline_remat_window = -1``), kept so a config resolves the same
    W; the port's schedule has no scan to window."""
    T = M * vpp + pp - 1
    lpc = cfg.num_layers // (pp * vpp)
    c = _recompute_cost(cfg, cfg.recompute)
    return max(int(round((T / (2.0 + lpc * c)) ** 0.5)), 1)


def pipeline_activation_bytes(cfg: ModelConfig, *, pp: int, vpp: int,
                              M: int, mb: int, seq_shard: int) -> dict:
    """Predicted activation memory of one stage of the port's schedule
    (the most of any stage), in bytes; the counterpart of JAX's
    ``pipeline_activation_bytes``, which describes its scan.

    With ``F = max_in_flight`` forwards awaiting their backward, a
    boundary tensor ``[mb, seq_shard, h]`` of B bytes an element and the
    model's recompute policy (``cfg.recompute``), at one tp rank:

    - ``boundary``: each in-flight forward keeps its input (a received
      leaf) and its output, and the step holds one sent and one received
      tensor each way: ``(2 F + 4)`` boundaries;
    - ``layer_residuals``: each in-flight forward keeps its chunk's
      saved values, ``lpc * c`` boundaries (``c`` the recompute policy's
      saved tensors a layer, ``_saved_per_layer``);
    - ``head``: the last stage's fp32 logits, softmax and their grad,
      ``3 * mb * seq * V * 4``, transient;
    - ``io_grads``: fp32 grads of the embedding and head, ``2 * V * h *
      4``.
    """
    h = cfg.hidden_size
    lpc = cfg.num_layers // (pp * vpp)
    B = torch.tensor([], dtype=cfg.dtype).element_size()
    v = cfg.padded_vocab_size()
    per = mb * seq_shard * h * B
    f = max(max_in_flight(pp, vpp, M))
    terms = {"in_flight": f,
             "boundary": (2 * f + 4) * per,
             "layer_residuals": int(f * lpc
                                    * _saved_per_layer(cfg, cfg.recompute)
                                    * per),
             "head": 3 * mb * seq_shard * v * 4,
             "io_grads": 2 * v * h * 4}
    terms["total"] = sum(v for k, v in terms.items() if k != "in_flight")
    return terms


# ---------------------------------------------------------------------------
# The pipelined loss and grads
# ---------------------------------------------------------------------------


def _head(cfg: ModelConfig, io, h, labels, mask, denom, want_stats: bool):
    """Final norm → unembed → CE on one finished microbatch: ``(loss,
    per_token, correct)``, the last two with ``want_stats``."""
    group, tp, _ = mesh_lib.axis_info("tp")
    h = norm_apply(cfg.norm_type, h, io["final_norm"], cfg.norm_eps,
                   impl=cfg.norm_impl)
    logits = model_lib.unembed(cfg, io, h).float()
    if tp > 1:
        per_token = vocab_parallel_cross_entropy(logits, labels, group,
                                                 vocab_size=cfg.vocab_size)
    else:
        per_token = cross_entropy(logits, labels, vocab_size=cfg.vocab_size)
    loss = masked_mean_loss(per_token, mask, denom)
    correct = None
    if want_stats:
        full = mappings.all_gather(logits.detach(), group, -1)
        correct = (torch.argmax(full, dim=-1) == labels).float()
    return loss, per_token, correct


def _boundary_shape(cfg: RuntimeConfig, mb: int, s: int) -> tuple:
    _, tp, _ = mesh_lib.axis_info("tp")
    sp = tp > 1 and cfg.model.sequence_parallel_axis is not None
    return (mb, s // tp if sp else s, cfg.model.hidden_size)


def run_lockstep(steps: list, stage: int, vpp: int, shape: tuple, dtype,
                 device, forward, backward) -> None:
    """Run this stage's part of the lockstep ``steps`` (``build_schedule``;
    every stage of the current mesh's pp group calls it with the same
    steps): ``forward(m, c, x_in)`` (``x_in`` None at chunk 0 of stage 0)
    returns the tensor its successor takes, or None after the last chunk;
    ``backward(m, c, g_out)`` (``g_out`` None where the forward returned
    None) returns the input's grad, or None at chunk 0 of stage 0.  After
    each step the forwards' outputs move one ring position on and the
    input grads one back, each a ``mappings.ppermute`` of ``shape`` over
    the pp group of the pairs that send; ``last_p2p_seconds`` keeps the
    time spent in them."""
    pp_group, pp, _ = mesh_lib.axis_info(PP)
    recv_f, recv_b = {}, {}
    p2p = 0.0
    for row in steps:
        act = row[stage]
        sent_f = sent_b = None
        if act is not None:
            kind, m, c = act
            if kind == "F":
                sent_f = forward(m, c, recv_f.pop((m, c), None))
            else:
                sent_b = backward(m, c, recv_b.pop((m, c), None))
        t0 = time.perf_counter()
        # the outputs one ring position on, the input grads one back
        for kind, where, store, sent in (
                ("F", next_position, recv_f, sent_f),
                ("B", prev_position, recv_b, sent_b)):
            pairs, dest = [], {}
            for s_, a in enumerate(row):
                if a is None or a[0] != kind:
                    continue
                to = where(s_, a[2], pp, vpp)
                if to is not None:
                    pairs.append((s_, to[0]))
                    dest[to[0]] = (a[1], to[1])
            if not pairs:
                continue
            buf = sent if sent is not None else torch.empty(
                shape, dtype=dtype, device=device)
            got = mappings.ppermute(buf.to(dtype), pp_group, pairs)
            if stage in dest:
                store[dest[stage]] = got
        p2p += time.perf_counter() - t0
    last_p2p_seconds[0] = p2p


def pipeline_grads(cfg: RuntimeConfig, params: PyTree, batch: dict, *,
                   rng=None, rope=None, loss_scale: float = 1.0,
                   backward: bool = True, return_stats: bool = False):
    """One step's pipeline on this stage (inside the mesh): ``params`` in
    the pipeline layout (this rank's ``[vpp, 1, lpc, ...]`` layers),
    ``batch`` leaves ``[M, mb, ...]``.

    Returns ``(grads, loss, aux, stats)``: the fp32 grads of this stage's
    leaves, the mean over microbatches of ``d(loss_m * loss_scale)`` (the
    embedding and head's not yet summed over pp; None without
    ``backward``); the loss, the mean of the microbatches' masked-mean
    losses (the same on every stage); the MoE stats summed over this
    stage's layers and the microbatches (None for a dense model); and
    with ``return_stats`` ``{"per_token_loss", "correct"}`` ``[M, mb,
    s]`` (the same on every stage)."""
    from ..models import moe

    model = cfg.model
    mesh = mesh_lib.current_mesh()
    pp_group, pp, stage = mesh_lib.axis_info(PP)
    vpp = cfg.parallel.virtual_pipeline_stages
    dp_group, dp, dp_index = mesh_lib.axis_info("dp")
    if mesh is None or pp != cfg.parallel.pipeline_parallel:
        raise ValueError("pipeline_grads runs inside its mesh "
                         "(parallel.mesh.use_mesh)")
    tokens = batch["tokens"]
    M, mb, s = tokens.shape
    steps = build_schedule(pp, vpp, M, backward)
    lpc = model.num_layers // (pp * vpp)
    if rope is None:
        rope = rope_tables(model, device=tokens.device)
    cos, sin = rope
    pos, seg = batch.get("position_ids"), batch.get("segment_ids")
    denom = batch.get("loss_denom")
    moe_on = model.num_experts > 0

    embed_key = stack_key = None
    if rng is not None:
        embed_key, stack_key = drop.split(rng)
        if dp > 1:   # a stream of its own a dp shard (JAX's fold)
            embed_key = drop.fold_in(embed_key, dp_index)
            stack_key = drop.fold_in(stack_key, dp_index)

    layers = params["layers"]
    io = {k: v for k, v in params.items() if k != "layers"}
    # each chunk's leaves as leaves of their own (views of the params), so
    # a backward's grads are the chunk's alone
    chunks = [tree_map(lambda x, c=c: x[c, 0].detach().requires_grad_(
        backward), layers) for c in range(vpp)]
    io_live = tree_map(lambda x: x.detach().requires_grad_(backward), io)
    io_leaves = tree_leaves(io_live)
    acc_layers = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                          layers) if backward else None
    acc_layer_leaves = tree_leaves(acc_layers) if backward else []
    acc_io = [torch.zeros_like(x, dtype=torch.float32) for x in io_leaves] \
        if backward else []

    shape = _boundary_shape(cfg, mb, s)
    dtype = model.dtype
    cp = mesh_lib.axis_info(mesh_lib.CONTEXT_AXIS)[1]
    saved = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux_sum = None
    stats = None
    if return_stats:
        stats = (torch.zeros((M, mb, s), device=tokens.device),
                 torch.zeros((M, mb, s), device=tokens.device))
    last = stage == pp - 1

    def run_forward(m, c, x_in):
        nonlocal loss_sum, aux_sum
        first = stage == 0 and c == 0
        if first:
            ek = None if embed_key is None else drop.fold_in(embed_key, m)
            x = model_lib.embed(model, io_live, tokens[m],
                                None if pos is None else pos[m], None,
                                ek).to(dtype)
        else:
            if backward:
                x_in.requires_grad_(True)
            x = x_in
        side = AttnSideInputs(
            rope_cos=cos, rope_sin=sin,
            position_ids=None if pos is None else pos[m],
            segment_ids=None if seg is None else seg[m])
        key = None if stack_key is None else drop.fold_in(
            drop.fold_in(stack_key, m), c * pp + stage)
        out, aux = stack_forward(model, chunks[c], x, side, key,
                                 layer_offset=(c * pp + stage) * lpc,
                                 return_aux=True)
        if moe_on:
            aux_sum = moe.add_stats(aux_sum, tree_map(
                lambda a: a.detach(), aux))
        if last and c == vpp - 1:
            loss, per_tok, correct = _head(
                model, io_live, out, batch["labels"][m],
                batch["loss_mask"][m], None if denom is None else denom[m],
                return_stats)
            loss_sum = loss_sum + loss.detach()
            if stats is not None:
                stats[0][m] = per_tok.detach()
                stats[1][m] = correct
            target = loss
        else:
            target = out
        if backward:
            saved[(m, c)] = (x_in, target, aux)
        return None if target is not out else out.detach()

    def run_backward(m, c, g_out):
        x_in, target, aux = saved.pop((m, c))
        if last and c == vpp - 1:
            outs, grads = [target * loss_scale], [None]
        else:
            outs, grads = [target], [g_out]
        if moe_on:
            # a shard's aux over cp: the step sums the loss over cp, and
            # JAX takes the aux's mean over its manual cp axis
            outs.append(moe.aux_loss_of(aux)
                        * (model.moe_aux_loss_coeff * loss_scale / cp))
            grads.append(None)
        chunk_leaves = tree_leaves(chunks[c])
        inputs = chunk_leaves + io_leaves + ([x_in] if x_in is not None
                                             else [])
        gs = torch.autograd.grad(outs, inputs, grad_outputs=grads,
                                 allow_unused=True)
        n = len(chunk_leaves)
        for acc, g in zip(acc_layer_leaves, gs[:n]):
            if g is not None:
                acc[c, 0].add_(g)
        for acc, g in zip(acc_io, gs[n:n + len(io_leaves)]):
            if g is not None:
                acc.add_(g)
        return gs[-1] if x_in is not None else None

    ctx = torch.enable_grad() if backward else torch.no_grad()
    with ctx, moe.shard_local_stats():
        run_lockstep(steps, stage, vpp, shape, dtype, tokens.device,
                     run_forward, run_backward)

    loss = mappings.all_reduce(loss_sum, pp_group)
    if stats is not None:
        stats = {"per_token_loss": mappings.all_reduce(stats[0], pp_group),
                 "correct": mappings.all_reduce(stats[1], pp_group)}
    inv = 1.0 / M
    loss = loss * inv
    grads = None
    if backward:
        if M > 1:
            for g in acc_layer_leaves + acc_io:
                g.mul_(inv)
        io_grads = tree_unflatten(io, acc_io)
        grads = {k: acc_layers if k == "layers" else io_grads[k]
                 for k in params}
    return grads, loss, aux_sum, stats


def pipeline_loss(cfg: RuntimeConfig, params: PyTree, batch: dict, *,
                  rng=None, rope=None, return_stats: bool = False):
    """The forward-only pipelined loss (the eval step's): the mean over
    microbatches of the masked-mean LM loss, plus the MoE aux term of
    JAX's ``pipeline_loss`` (the coefficient times the aux summed over
    every layer and microbatch, over M); with ``return_stats`` also the
    per-token stats."""
    _, loss, aux, stats = pipeline_grads(cfg, params, batch, rng=rng,
                                         rope=rope, backward=False,
                                         return_stats=return_stats)
    loss = loss + aux_term(cfg, aux, batch["tokens"].shape[0])
    return (loss, stats) if return_stats else loss


def aux_term(cfg: RuntimeConfig, aux, M: int):
    """``coeff * aux / (M * cp)`` of the aux summed over the pp group (0
    for a dense model): a cp shard's share, as the step sums the loss over
    cp (JAX takes the mean over its manual cp axis)."""
    if aux is None:
        return 0.0
    from ..models import moe

    total = mappings.all_reduce(moe.aux_loss_of(aux).clone(),
                                mesh_lib.axis_info(PP)[0])
    cp = mesh_lib.axis_info(mesh_lib.CONTEXT_AXIS)[1]
    return cfg.model.moe_aux_loss_coeff * total / (M * cp)
