"""Split-rank pipeline parallelism for the encoder-decoder (T5) and
encoder-only (BERT) families (mirror of
``megatron_llm_tpu/parallel/pipeline_encdec.py``; reference
``pipeline_model_parallel_split_rank``, megatron/core/parallel_state.py:
110-112: stages below the split hold the encoder, the rest the decoder).

The layout is JAX's, leaf for leaf: T5's encoder layers ``reshape(split,
lpc)`` over stages ``[0, split)`` and its decoder layers ``reshape(pp -
split, lpc)`` over ``[split, pp)``, stacked into one ``[pp, lpc, ...]``
tree (``layers``), and the decoder's cross-attention blocks ``[pp, lpc,
...]`` (``cross``) with zeros on the encoder stages; BERT's stack
``[pp, lpc, ...]``.  Both segments must share one layers-per-chunk.  The
embedding, the norms and the heads stay replicated over pp, and the step
sums their grads over pp (``training/step.reduce_grads``), as for the
decoder pipeline.  ``*_to_pipeline_params`` and ``*_from_pipeline_params``
convert, so a checkpoint of this layout round-trips.

The schedule is plain 1F1B (``parallel/pipeline.build_schedule(pp, 1,
M)``, run by ``run_lockstep``): interleaving (vpp > 1) and context
parallelism are refused, as JAX refuses them (its ``pipeline_encdec.py``
:302-306, :539-542; the reference builds virtual chunks for GPT alone).
``pipeline_remat_window`` resolves as in JAX and changes nothing here:
the port's 1F1B keeps at most pp microbatches in flight
(``parallel/pipeline.auto_remat_window``).

The stage bodies.  JAX runs one SPMD body on every stage, so a static
``causal`` flag cannot differ between stages: it builds an additive
segment bias per stage (which takes attention off its flash kernel) and
multiplies the cross-attention block by ``is_decoder``.  Here each rank
is a process that knows its stage, so each stage runs the unpipelined
model's own code for its part (``models/encdec.py``): an encoder stage
``encoder_forward`` (bidirectional, the pads in segment 0), a decoder
stage ``t5_decoder_forward`` (causal self-attention with the pads as
segments, cross-attention over the encoder's output, the MLP: JAX's
order, to which its uniform body degenerates bitwise), so
``attention_impl="flash"`` takes the flash kernels on both, as the
unpipelined families do.  An encoder stage never touches its zero
cross-attention weights, whose grads are therefore exactly 0 (JAX's mask
gives the same): they stay a fixed point of training.

The carry.  The encoder's output rides the ring with its microbatch, as
in JAX: the split stage takes the arriving encoder hidden through
``enc_norm`` as the cross-attention context and starts the decoder on the
embedding of the microbatch's decoder tokens; every decoder stage passes
the context on beside its hidden state.  One ``ppermute`` moves one
tensor of one shape over the pp group, so the carry is ``[mb, s_enc +
s_dec, h]``: ``[hidden | zeros]`` from an encoder stage, ``[context |
hidden]`` from a decoder stage.  Each stage computes at its own length
(``s_enc`` or ``s_dec``), so no padded position enters any attention;
JAX pads the hidden state to ``max(s_enc, s_dec)`` and carries padding
as segment-0 positions.  The context's grads come back through the
reverse sends and reach the encoder at the split stage.

Dropout (a stage's key ``fold_in(fold_in(key, microbatch), stage)``, the
dp shard folded in first, as JAX's): a decoder stage's layers fold in
their index and salts 2, 3 and 4, JAX's pipelined chain; an encoder
stage runs the unpipelined encoder's stack (salts 2 and 3, drop-path at
the global layer index), where JAX's uniform body draws salts 2 and 4.

``t5_pipeline_loss`` and ``bert_pipeline_loss`` are grads functions, the
``pipeline_loss_fn`` of ``training.driver.pretrain_custom``: ``(grads,
loss)`` of this stage as ``parallel/pipeline.pipeline_grads`` gives them
(``backward=False`` gives the loss alone, the pipelined evaluation).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..config import ModelConfig, RuntimeConfig
from ..models import encdec
from ..ops import dropout as drop
from ..ops.norms import norm_apply
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import mappings
from . import mesh as mesh_lib
from .pipeline import PP, build_schedule, run_lockstep

PyTree = Any


def resolve_split(parallel) -> int:
    """The encoder/decoder stage split (the reference's default: pp // 2
    when ``pipeline_split_rank`` is unset)."""
    pp = parallel.pipeline_parallel
    split = parallel.pipeline_split_rank
    if split is None:
        split = pp // 2
    if not 0 < split < pp:
        raise ValueError(f"pipeline_split_rank {split} must lie in (0, {pp})"
                         " for the split-rank pipeline")
    return split


def _check_chunks(n_enc: int, n_dec: int, split: int, pp: int) -> int:
    enc_stages, dec_stages = split, pp - split
    if n_enc % enc_stages:
        raise ValueError(
            f"encoder layers {n_enc} must divide over {enc_stages} stages")
    if n_dec % dec_stages:
        raise ValueError(
            f"decoder layers {n_dec} must divide over {dec_stages} stages")
    lpc_e, lpc_d = n_enc // enc_stages, n_dec // dec_stages
    if lpc_e != lpc_d:
        raise ValueError(
            f"encoder ({n_enc}/{enc_stages}={lpc_e}) and decoder "
            f"({n_dec}/{dec_stages}={lpc_d}) layers-per-stage must match for "
            "the uniform stage stacking; choose split so both segments get "
            "equal chunks (T5's symmetric depths with split = pp/2 do)")
    return lpc_e


def _check_schedule(parallel) -> None:
    """JAX's refusals (its ``pipeline_encdec.py``:302-306, :539-542)."""
    if parallel.virtual_pipeline_stages != 1:
        raise ValueError("interleaved (vpp > 1) schedules are decoder-only, "
                         "as in the reference (megatron/training.py:206-221)")
    if parallel.context_parallel != 1:
        raise ValueError("context parallelism is decoder-only")


# ---------------------------------------------------------------------------
# The stage-stacked layouts
# ---------------------------------------------------------------------------


def _n_layers(stack: PyTree) -> int:
    return tree_leaves(stack)[0].shape[0]


def t5_to_pipeline_params(params: PyTree, parallel) -> PyTree:
    """``init_t5_params``' layout → ``{"layers": [pp, lpc, ...] (encoder
    stages first), "cross": [pp, lpc, ...] (zeros on encoder stages), and
    the replicated embedding, enc_norm, dec_norm, lm_head_bias}``."""
    pp = parallel.pipeline_parallel
    split = resolve_split(parallel)
    enc, dec = params["encoder"], params["decoder"]
    lpc = _check_chunks(_n_layers(enc), _n_layers(dec), split, pp)

    def stack_self(e, d):
        return torch.cat([e.reshape((split, lpc) + tuple(e.shape[1:])),
                          d.reshape((pp - split, lpc) + tuple(d.shape[1:]))])

    def stack_cross(c):
        staged = c.reshape((pp - split, lpc) + tuple(c.shape[1:]))
        return torch.cat([torch.zeros((split, lpc) + tuple(c.shape[1:]),
                                      dtype=c.dtype, device=c.device),
                          staged])

    return {"layers": tree_map(stack_self, enc, dec),
            "cross": tree_map(stack_cross, params["cross"]),
            "embedding": params["embedding"],
            "enc_norm": params["enc_norm"],
            "dec_norm": params["dec_norm"],
            "lm_head_bias": params["lm_head_bias"]}


def _unstack(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def t5_from_pipeline_params(staged: PyTree, parallel) -> PyTree:
    """The inverse of ``t5_to_pipeline_params`` (checkpoint interop)."""
    split = resolve_split(parallel)
    return {"embedding": staged["embedding"],
            "encoder": tree_map(lambda x: _unstack(x[:split]),
                                staged["layers"]),
            "decoder": tree_map(lambda x: _unstack(x[split:]),
                                staged["layers"]),
            "cross": tree_map(lambda x: _unstack(x[split:]), staged["cross"]),
            "enc_norm": staged["enc_norm"],
            "dec_norm": staged["dec_norm"],
            "lm_head_bias": staged["lm_head_bias"]}


def bert_to_pipeline_params(params: PyTree, parallel) -> PyTree:
    """``init_bert_params``' layout → the ``[pp, lpc, ...]`` staged
    layers."""
    pp = parallel.pipeline_parallel
    n = _n_layers(params["layers"])
    if n % pp:
        raise ValueError(f"num_layers {n} must divide over "
                         f"pipeline_parallel {pp} stages")
    out = dict(params)
    out["layers"] = tree_map(
        lambda x: x.reshape((pp, n // pp) + tuple(x.shape[1:])),
        params["layers"])
    return out


def bert_from_pipeline_params(staged: PyTree, parallel=None) -> PyTree:
    out = dict(staged)
    out["layers"] = tree_map(_unstack, staged["layers"])
    return out


def _staged_specs(layer_specs: PyTree) -> PyTree:
    """Per-layer-stack specs ``(None, *dims)`` → ``("pp", None, *dims)``
    for the ``[pp, lpc, ...]`` layout (the flat spec's layer dim becomes
    the lpc dim)."""
    return tree_map(lambda s: (PP,) + tuple(s) if len(s) else (PP, None),
                    layer_specs)


def t5_pipeline_param_specs(cfg: ModelConfig, parallel) -> PyTree:
    base = encdec.t5_param_specs(cfg, parallel)
    return {"layers": _staged_specs(base["encoder"]),
            "cross": _staged_specs(base["cross"]),
            "embedding": base["embedding"],
            "enc_norm": base["enc_norm"],
            "dec_norm": base["dec_norm"],
            "lm_head_bias": base["lm_head_bias"]}


def bert_pipeline_param_specs(cfg: ModelConfig, parallel) -> PyTree:
    out = dict(encdec.bert_param_specs(cfg, parallel))
    out["layers"] = _staged_specs(out["layers"])
    return out


# ---------------------------------------------------------------------------
# The pipelined grads
# ---------------------------------------------------------------------------


def _stage_keys(rng, deterministic: bool):
    """``key(m)``: the stage's dropout key of microbatch ``m`` (None
    without dropout), the dp shard folded in first."""
    if rng is None or deterministic:
        return lambda m: None
    _, dp, dp_index = mesh_lib.axis_info("dp")
    _, _, stage = mesh_lib.axis_info(PP)
    if dp > 1:
        rng = drop.fold_in(rng, dp_index)
    return lambda m: drop.fold_in(drop.fold_in(rng, m), stage)


def _run(cfg: RuntimeConfig, params: PyTree, stacked: tuple, M: int,
         shape: tuple, device, body, backward: bool, loss_scale: float):
    """This stage's 1F1B over ``M`` microbatches: ``body(m, x_in, live)``
    runs the stage on microbatch ``m`` (``x_in`` the carry it received,
    None on stage 0) with ``live`` the stage's params (the ``stacked``
    subtrees at this stage's ``[lpc, ...]``) and returns ``(carry, None)``
    or, on the last stage, ``(None, loss)``.  Returns ``(grads, loss)`` as
    ``parallel/pipeline.pipeline_grads`` does."""
    _check_schedule(cfg.parallel)
    mesh = mesh_lib.current_mesh()
    pp_group, pp, stage = mesh_lib.axis_info(PP)
    if mesh is None or pp != cfg.parallel.pipeline_parallel:
        raise ValueError("the encoder pipelines run inside their mesh "
                         "(parallel.mesh.use_mesh)")
    live = {k: tree_map(lambda x, st=k in stacked: (
        x[0] if st else x).detach().requires_grad_(backward), v)
        for k, v in params.items()}
    leaves = tree_leaves(live)
    acc = [torch.zeros_like(x, dtype=torch.float32) for x in leaves] \
        if backward else []
    saved = {}
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)

    def forward(m, c, x_in):
        nonlocal loss_sum
        if x_in is not None and backward:
            x_in.requires_grad_(True)
        carry, loss = body(m, x_in, live)
        if loss is not None:
            loss_sum = loss_sum + loss.detach()
        if backward:
            saved[m] = (x_in, carry, loss)
        return None if carry is None else carry.detach()

    def backward_fn(m, c, g_out):
        x_in, carry, loss = saved.pop(m)
        out, grad = (carry, g_out) if loss is None else \
            (loss * loss_scale, None)
        inputs = leaves + ([x_in] if x_in is not None else [])
        gs = torch.autograd.grad([out], inputs, grad_outputs=[grad],
                                 allow_unused=True)
        for a, g in zip(acc, gs[:len(leaves)]):
            if g is not None:
                a.add_(g)
        return gs[-1] if x_in is not None else None

    ctx = torch.enable_grad() if backward else torch.no_grad()
    with ctx:
        run_lockstep(build_schedule(pp, 1, M, backward), stage, 1, shape,
                     cfg.model.dtype, device, forward, backward_fn)
    loss = mappings.all_reduce(loss_sum, pp_group) * (1.0 / M)
    if not backward:
        return None, loss
    for a in acc:
        a.mul_(1.0 / M)
    grads = tree_unflatten(live, acc)
    for k in stacked:
        grads[k] = tree_map(lambda g: g[None], grads[k])
    return grads, loss


def _microbatch(batch: dict, m: int, keys: tuple) -> dict:
    """Microbatch ``m`` of the head's inputs (``loss_denom`` ``[M]``
    included where the step counted it)."""
    return {k: batch[k][m] for k in keys + ("loss_denom",) if k in batch}


def t5_pipeline_loss(cfg: RuntimeConfig, params: PyTree, batch: dict, *,
                     rng=None, loss_scale: float = 1.0,
                     backward: bool = True):
    """``(grads, loss)`` of this stage through the split-rank pipeline:
    ``params`` in ``t5_to_pipeline_params``' layout (this rank's ``[1,
    lpc, ...]`` stage), ``batch`` leaves ``[M, mb, ...]``: enc_tokens
    ``[M, mb, s_enc]``; dec_tokens, labels, loss_mask ``[M, mb, s_dec]``;
    optionally enc_pad_mask and dec_pad_mask.  The loss is the mean over
    microbatches of ``encdec.t5_loss``."""
    model = cfg.model
    _, pp, stage = mesh_lib.axis_info(PP)
    split = resolve_split(cfg.parallel)
    enc_tok, dec_tok = batch["enc_tokens"], batch["dec_tokens"]
    M, mb, s_enc = enc_tok.shape
    s_dec = dec_tok.shape[2]
    enc_pad, dec_pad = batch.get("enc_pad_mask"), batch.get("dec_pad_mask")
    deterministic = rng is None
    key = _stage_keys(rng, deterministic)
    lpc = tree_leaves(params["layers"])[0].shape[1]

    def at(t, m):
        return None if t is None else t[m]

    def body(m, x_in, p):
        if stage < split:
            h = encdec.t5_embed(model, p, enc_tok[m]) if stage == 0 \
                else x_in[:, :s_enc]
            out = encdec.encoder_forward(model, p["layers"], h,
                                         at(enc_pad, m), key(m),
                                         deterministic,
                                         layer_offset=stage * lpc)
            return F.pad(out, (0, 0, 0, s_dec)), None
        if stage == split:
            ctx = norm_apply(model.norm_type, x_in[:, :s_enc], p["enc_norm"],
                             model.norm_eps, impl=model.norm_impl)
            h = encdec.t5_embed(model, p, dec_tok[m])
        else:
            ctx, h = x_in[:, :s_enc], x_in[:, s_enc:]
        out = encdec.t5_decoder_forward(model, p["layers"], p["cross"], h,
                                        ctx, at(dec_pad, m), at(enc_pad, m),
                                        key(m), deterministic)
        if stage == pp - 1:
            return None, encdec.t5_head_loss(
                model, p, out, _microbatch(batch, m, ("labels",
                                                      "loss_mask")))
        return torch.cat([ctx, out], dim=1), None

    return _run(cfg, params, ("layers", "cross"), M,
                (mb, s_enc + s_dec, model.hidden_size), enc_tok.device, body,
                backward, loss_scale)


def bert_pipeline_loss(cfg: RuntimeConfig, params: PyTree, batch: dict, *,
                       rng=None, loss_scale: float = 1.0,
                       backward: bool = True):
    """``(grads, loss)`` of this stage through the encoder pipeline:
    ``params`` in ``bert_to_pipeline_params``' layout, ``batch`` leaves
    ``[M, mb, ...]`` (tokens, pad_mask, labels, loss_mask; optionally
    tokentype_ids and is_random).  The loss is the mean over microbatches
    of ``encdec.bert_loss``."""
    model = cfg.model
    _, pp, stage = mesh_lib.axis_info(PP)
    tokens, pad = batch["tokens"], batch["pad_mask"]
    tokentype = batch.get("tokentype_ids")
    M, mb, s = tokens.shape
    deterministic = rng is None
    key = _stage_keys(rng, deterministic)
    lpc = tree_leaves(params["layers"])[0].shape[1]

    def body(m, x_in, p):
        h = x_in if stage > 0 else encdec.bert_embed(
            model, p, tokens[m], None if tokentype is None else tokentype[m])
        out = encdec.encoder_forward(model, p["layers"], h, pad[m], key(m),
                                     deterministic, layer_offset=stage * lpc)
        if stage == pp - 1:
            return None, encdec.bert_head_loss(
                model, p, out, _microbatch(batch, m, ("labels", "loss_mask",
                                                      "is_random")))
        return out, None

    return _run(cfg, params, ("layers",), M, (mb, s, model.hidden_size),
                tokens.device, body, backward, loss_scale)
