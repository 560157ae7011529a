"""Decoder transformer stack (mirror of
``megatron_llm_tpu/models/transformer.py``).

Parameters keep the JAX package's stacked layout: a dict whose leaves
carry a leading layer axis ``[L, ...]`` (``x @ w`` with w ``[in, out]``),
so ``convert.params_from_jax`` is a plain leaf-for-leaf copy.  The stack is
a Python loop over layers in place of ``lax.scan``.

``stack_forward`` serves inference and training.  Under autograd each
layer runs inside ``torch.utils.checkpoint`` as ``cfg.recompute`` says:
``"full"`` recomputes the whole layer in the backward, ``"selective"``
saves the projection matmuls' outputs (``aten.mm``; with int8 training
matmuls the int32 products and the int8 operands) and recomputes the
rest, as JAX's ``dots_with_no_batch_dims_saveable`` policy does, and
``"none"`` saves everything.  The policy changes memory and time, not the
numbers, with dropout on too: ``stack_forward`` takes the stack's
``DropoutKey`` and each layer folds in its index, so a recomputed layer
redraws the forward's masks from the same keys (``ops/dropout.py``).
Without a key the forward is deterministic.  Serving-quantized weights
(``ops/quant.py``) go through ``mm``, and ``quantize_matmuls="int8"``
sends plain weights through ``int8_training_matmul``; a MoE model's MLP
is ``models/moe.moe_block`` (``mlp_dispatch``; under sequence
parallelism it gathers and splits the sequence itself), its stats summed
down the stack.  ``stack_forward`` and
``stack_forward_cached`` take the LoRA bundle (``ops/lora.py``): each
targeted projection gains its grouped epilogue right after the base
product, on the training path (LoRA finetuning, ``training/lora.py``)
as in serving.

Under a current mesh (``parallel/mesh.use_mesh``) with tp > 1 each rank
holds its shards (``models/sharding.py``) and the blocks write out the
collectives GSPMD derives in JAX (``parallel/mappings.py``): the column
products (wq, wk, wv, w_gate, w_up) take their input through
``column_input`` and the row products (wo, w_down) leave through
``row_output``, their biases added once, after the reduction.  A rank
runs ``nq / tp`` query heads and ``nkv / tp`` kv heads, or, where the kv
heads do not divide by tp (Falcon-7B's MQA), the one replicated kv head
its query heads read.  Under sequence parallelism
(``cfg.sequence_parallel_axis``) the residual stream, the norms and the
dropout hold this rank's ``s / tp`` block of the sequence, the column
inputs all-gather it and the row outputs reduce-scatter it, JAX's
``seq_constrain``.  LoRA runs at tp = 1 only.

The KV-cached forward (serving) runs under the serving re-layout
(``models/sharding.serving_param_specs``): under tp each rank runs its
heads and caches its kv heads (all of them where they do not divide by
tp: its query heads read their one kv head out of the whole cache);
under pp ``stack_forward_cached`` runs this rank's contiguous slab of
layers over its slab of the cache, the hidden state going stage to stage
through ``mappings.ppermute`` and the last stage's sent back to every
stage; under fsdp each layer's weights are gathered whole over the fsdp
group just before the layer and dropped after it
(``sharding.fsdp_whole``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config import ModelConfig, PositionEmbeddingType
from ..ops import dropout as drop
from ..ops.activations import get_activation, is_glu
from ..ops.attention import attention, decode_attention
from ..ops.kv_quant import cache_update
from ..ops.lora import lora_delta
from ..ops.norms import norm_apply, norm_init
from ..ops.quant import int8_training_matmul, is_quantized, \
    is_quantized_int4, mm
from ..ops.rope import apply_rope, precompute_rope_freqs
from ..parallel import mappings
from ..parallel.mesh import axis_info, current_mesh
from ..utils.tree import tree_map
from .sharding import fsdp_whole

Params = dict


def proj(cfg: ModelConfig, x: torch.Tensor, w) -> torch.Tensor:
    """Projection matmul dispatch: under ``quantize_matmuls="int8"`` a
    plain weight goes through the W8A8 ``int8_training_matmul``; else
    ``ops/quant.mm``: a plain weight is ``x @ w`` (a large product, left
    to torch.matmul as the JAX package left it to XLA), a
    serving-quantized ``{"q", "scale"}`` weight is dequantized into the
    product."""
    if cfg.quantize_matmuls == "int8" and not is_quantized(w):
        return int8_training_matmul(x, w)
    return mm(x, w)


def tp_layout(cfg: ModelConfig) -> tuple:
    """``(group, size, index, sequence_parallel)`` of the current mesh's
    tp axis; ``(None, 1, 0, False)`` without a mesh."""
    group, size, index = axis_info("tp")
    return group, size, index, size > 1 and \
        cfg.sequence_parallel_axis is not None


def seq_slices(cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """The dropout block of a ``[b, s, ...]`` tensor: this rank's sequence
    block under sequence parallelism and context parallelism (the cp
    block of the sequence as the step laid it out, then its tp block;
    ``ops/dropout.block_mask``)."""
    _, tp, index, sp = tp_layout(cfg)
    _, cp, cp_index = axis_info("cp")
    if not sp:
        tp, index = 1, 0
    if tp * cp == 1:
        return ()
    s = x.shape[1]
    return ((1, s * tp * cp, (cp_index * tp + index) * s),)


def _refuse_tp(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} under tensor parallelism is not ported yet (ROADMAP.md, "
        f"Queue 1 {item})")


def local_kv_heads(cfg: ModelConfig, k, v, nq: int, tp: int, rank: int):
    """``(k, v, dropout slices)`` for this rank's ``nq`` query heads.
    Under tp the kv heads are this rank's block, or, replicated where they
    do not divide by tp, the one kv head its query heads read; the slices
    place the rank's ``[b, kv, group, sq, sk]`` probabilities in the
    global mask."""
    if tp == 1:
        return k, v, ()
    n_kv, n_group = cfg.kv_heads, cfg.num_attention_heads // cfg.kv_heads
    if n_kv % tp == 0:
        return k, v, ((1, n_kv, rank * k.shape[2]),)
    kv_i = rank * nq // n_group
    return (k[:, :, kv_i:kv_i + 1], v[:, :, kv_i:kv_i + 1],
            ((1, n_kv, kv_i), (2, n_group, rank * nq % n_group)))


def row_parallel_weight(w, tp: int, rank: int):
    """A row-parallel weight as this rank's product reads it: an int4
    leaf's ``q`` holds the rank's rows, but its scale keeps every group
    (``ops/quant.quantize_specs`` leaves the group axis whole), so the
    rank's groups are cut out here."""
    if tp == 1 or not is_quantized_int4(w):
        return w
    groups = w["scale"].shape[-2]
    if groups % tp:
        raise ValueError(
            f"an int4 row-parallel weight's {groups} scale groups do not "
            f"divide over tp = {tp}")
    n = groups // tp
    return {"q": w["q"],
            "scale": w["scale"][..., rank * n:(rank + 1) * n, :]}


def _cache_heads(cache, head: int):
    """kv head ``head`` of a ``[b, nkv, len(, d)]`` cache (each leaf of
    the int8 form), contiguous."""
    def one(a):
        if a.shape[1] == 1:
            return a
        return a[:, head:head + 1].contiguous()

    if isinstance(cache, dict):
        return {k: one(v) for k, v in cache.items()}
    return one(cache)


def _lora_add(y: torch.Tensor, x: torch.Tensor, lora, target: str):
    """``y`` plus the grouped LoRA epilogue of ``target`` (input ``x``, the
    projection's own input in the model's dtype, cast to fp32 inside
    ``lora_delta``), back in y's dtype; ``y`` itself when the layer has no
    bundle or the arena does not adapt ``target``.  ``lora`` is one
    layer's ``(factors, mask)``: ``{target: {"a": [in, Sr], "b": [Sr,
    out]}}`` and the per-row mask ``[b, Sr]``."""
    if lora is None:
        return y
    factors, mask = lora
    f = factors.get(target)
    if f is None:
        return y
    return (y + lora_delta(x, f["a"], f["b"], mask)).to(y.dtype)


# ---------------------------------------------------------------------------
# Initialization (std 0.02; output layers scaled by 1/sqrt(2 L))
# ---------------------------------------------------------------------------


def _normal(shape, std: float, dtype, generator, device) -> torch.Tensor:
    if generator is None:  # the meta device: shapes alone
        return torch.empty(shape, dtype=dtype, device=device)
    return (std * torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32)).to(dtype)


def init_stack_params(cfg: ModelConfig, generator: torch.Generator,
                      device, num_layers: Optional[int] = None,
                      place=None) -> Params:
    """All layers stacked on a leading axis; each layer is drawn on its
    own so the fp32 draw never holds more than one layer.  ``place(path,
    w)`` (``init_params``'s) takes each stacked matrix as soon as it is
    drawn."""
    n = num_layers if num_layers is not None else cfg.num_layers
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv, ffn = cfg.num_attention_heads, cfg.kv_heads, cfg.ffn_size
    dtype, std = cfg.dtype, cfg.init_method_std
    out_std = std / (2.0 * cfg.num_layers) ** 0.5 if cfg.use_scaled_init \
        else std
    shapes = {("attn", "wq"): ((h, nq * d), std),
              ("attn", "wk"): ((h, nkv * d), std),
              ("attn", "wv"): ((h, nkv * d), std),
              ("attn", "wo"): ((nq * d, h), out_std)}
    if cfg.num_experts > 0:
        from .moe import expert_shapes

        shapes[("mlp", "router")] = ((h, cfg.num_experts), std)
        shapes.update({("mlp", k): v for k, v in expert_shapes(cfg).items()})
    else:
        if is_glu(cfg.activation):
            shapes[("mlp", "w_gate")] = ((h, ffn), std)
        shapes[("mlp", "w_up")] = ((h, ffn), std)
        shapes[("mlp", "w_down")] = ((ffn, h), out_std)
    layers: Params = {"attn": {}, "mlp": {}}
    for (group, name), (shape, s) in shapes.items():
        # the MoE router stays fp32 (models/moe.py)
        wdt = torch.float32 if name == "router" else dtype
        w = torch.empty((n,) + shape, dtype=wdt, device=device)
        for i in range(n):
            w[i] = _normal(shape, s, wdt, generator, device)
        layers[group][name] = w if place is None \
            else place((group, name), w)
        del w

    def zeros(size):
        return torch.zeros(n, size, dtype=dtype, device=device)

    if cfg.use_bias or cfg.qkv_bias:
        layers["attn"].update(bq=zeros(nq * d), bk=zeros(nkv * d),
                              bv=zeros(nkv * d))
    if cfg.use_bias:  # (MoE MLPs are bias-free: ModelConfig.validate)
        layers["attn"]["bo"] = zeros(h)
        if is_glu(cfg.activation):
            layers["mlp"]["b_gate"] = zeros(ffn)
        layers["mlp"]["b_up"] = zeros(ffn)
        layers["mlp"]["b_down"] = zeros(h)

    def stacked_norm():
        return {k: v.expand(n, h).clone()
                for k, v in norm_init(cfg.norm_type, h, dtype, device).items()}

    layers["input_norm"] = stacked_norm()
    if cfg.parallel_attn:
        if cfg.parallel_layernorm:
            layers["mlp_norm"] = stacked_norm()
    else:
        layers["post_attn_norm"] = stacked_norm()
    return layers


def unstack_layers(stacked: Params) -> list:
    """Every layer's view of the stacked dict, from one ``unbind`` per
    leaf: autograd then joins the layers' grads into one ``[L, ...]`` grad
    per leaf, where a slice per layer would build a full-size grad for
    every layer."""
    parts = {k: unstack_layers(v) if isinstance(v, dict) else v.unbind(0)
             for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSideInputs:
    """Non-parameter inputs shared by all layers."""

    rope_cos: Optional[torch.Tensor] = None
    rope_sin: Optional[torch.Tensor] = None
    position_ids: Optional[torch.Tensor] = None  # [b, s]
    segment_ids: Optional[torch.Tensor] = None   # [b, s]
    causal: bool = True
    attn_bias: Optional[torch.Tensor] = None
    # the caller's promise that the KV cache holds no valid rows yet (first
    # prefill): cached attention is then ordinary causal attention over
    # the window (the flash kernel)
    cache_is_empty: bool = False


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    side: AttnSideInputs, layer_key=None,
                    kv_cache: Optional[tuple] = None, lora=None):
    """QKV projection → RoPE → attention → output projection.

    With a ``layer_key`` and ``cfg.attention_dropout`` the attention
    probabilities are dropped with the key folded with 1, as in JAX.
    ``kv_cache`` is ``(k_cache, v_cache, cache_len)`` with head-major
    caches ``[b, nkv, max_len, d]``; the new rows are written into the
    caches in place (``ops/kv_quant.cache_update``) and the call returns
    ``(out, (new_k_rows, new_v_rows))`` as in JAX.  ``lora`` is one layer's
    bundle (``_lora_add``): q, k and v take their deltas before RoPE, wo
    after its product."""
    group, tp, rank, sp = tp_layout(cfg)
    if tp > 1:
        if lora is not None:
            _refuse_tp("LoRA", "item 9's remainder")
        x = mappings.column_input(x, group, sp)
    b, s, _ = x.shape
    d = cfg.head_dim
    q = _lora_add(proj(cfg, x, p["wq"]), x, lora, "wq")
    k = _lora_add(proj(cfg, x, p["wk"]), x, lora, "wk")
    v = _lora_add(proj(cfg, x, p["wv"]), x, lora, "wv")
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    nq, nkv = q.shape[-1] // d, k.shape[-1] // d  # this rank's heads
    q = q.reshape(b, s, nq, d)
    k = k.reshape(b, s, nkv, d)
    v = v.reshape(b, s, nkv, d)
    k_rows, v_rows = k, v  # the heads this rank caches
    k, v, drop_slices = local_kv_heads(cfg, k, v, nq, tp, rank)
    position_ids = side.position_ids
    if kv_cache is not None and position_ids is None:
        raise ValueError("kv_cache requires explicit position_ids "
                         "(forward_cached supplies them)")
    if cfg.position_embedding_type == PositionEmbeddingType.ROTARY:
        q = apply_rope(q, side.rope_cos, side.rope_sin, position_ids)
        k = apply_rope(k, side.rope_cos, side.rope_sin, position_ids)
        if k_rows.shape[2] != k.shape[2]:
            k_rows = apply_rope(k_rows, side.rope_cos, side.rope_sin,
                                position_ids)
    if k_rows.shape[2] == k.shape[2]:
        k_rows, v_rows = k, v
    softmax_scale = 1.0 / (d ** 0.5)
    drop_key = None
    if layer_key is not None and cfg.attention_dropout > 0.0:
        drop_key = drop.fold_in(layer_key, 1)

    new_rows = None
    if kv_cache is not None:
        k_cache, v_cache, cache_len = kv_cache
        new_k = k_rows.transpose(1, 2)          # [b, nkv, s, d]
        new_v = v_rows.transpose(1, 2)
        cache_update(k_cache, new_k, cache_len)
        cache_update(v_cache, new_v, cache_len)
        new_rows = (new_k, new_v)
        if side.cache_is_empty and s > 1:
            ctx = attention(q, k.contiguous(), v.contiguous(),
                            impl=cfg.attention_impl, causal=True,
                            softmax_scale=softmax_scale)
        else:
            if k_rows.shape[2] != k.shape[2]:
                # kv heads replicated over tp: this rank's query heads
                # read their one kv head of the whole cache
                k_cache, v_cache = (_cache_heads(c, drop_slices[0][2])
                                    for c in (k_cache, v_cache))
            ctx = decode_attention(q, k_cache, v_cache, cache_len,
                                   softmax_scale=softmax_scale)
    else:
        ctx = attention(q, k.contiguous(), v.contiguous(),
                        impl=cfg.attention_impl, causal=side.causal,
                        segment_ids=side.segment_ids,
                        softmax_scale=softmax_scale,
                        dropout_rate=(0.0 if layer_key is None
                                      else cfg.attention_dropout),
                        dropout_key=drop_key, bias=side.attn_bias,
                        cp_axis=cfg.context_parallel_axis,
                        cp_zigzag=cfg.context_parallel_zigzag,
                        dropout_slices=drop_slices)
    ctx2d = ctx.reshape(b, s, nq * d)
    wo = row_parallel_weight(p["wo"], tp, rank)
    out = _lora_add(proj(cfg, ctx2d, wo), ctx2d, lora, "wo")
    if tp > 1:
        out = mappings.row_output(out, group, sp)
    if "bo" in p:
        out = out + p["bo"]
    if kv_cache is not None:
        return out, new_rows
    return out


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              lora=None) -> torch.Tensor:
    """(Gated) MLP with the GLU split as two projections; ``lora`` adds
    each targeted projection's delta after its product."""
    act = get_activation(cfg.activation)
    group, tp, rank, sp = tp_layout(cfg)
    if tp > 1:
        if lora is not None:
            _refuse_tp("LoRA", "item 9's remainder")
        x = mappings.column_input(x, group, sp)
    if is_glu(cfg.activation):
        gate = _lora_add(proj(cfg, x, p["w_gate"]), x, lora, "w_gate")
        up = _lora_add(proj(cfg, x, p["w_up"]), x, lora, "w_up")
        if "b_gate" in p:
            gate = gate + p["b_gate"]
            up = up + p["b_up"]
        hidden = act(torch.cat([gate, up], dim=-1))
    else:
        hidden = _lora_add(proj(cfg, x, p["w_up"]), x, lora, "w_up")
        if "b_up" in p:
            hidden = hidden + p["b_up"]
        hidden = act(hidden)
    w_down = row_parallel_weight(p["w_down"], tp, rank)
    out = _lora_add(proj(cfg, hidden, w_down), hidden, lora, "w_down")
    if tp > 1:
        out = mappings.row_output(out, group, sp)
    if "b_down" in p:
        out = out + p["b_down"]
    return out


def mlp_dispatch(cfg: ModelConfig, p: Params, x: torch.Tensor, lora=None):
    """Dense or routed MLP → ``(out, stats)``: the stats None for a dense
    model, the MoE stats dict (``models/moe.py``) for a routed one (JAX
    ``_mlp_dispatch``; a MoE model's experts take no LoRA, which
    ``training/lora.py`` and the adapter registry refuse)."""
    if cfg.num_experts > 0:
        from .moe import moe_block

        return moe_block(cfg, p, x)
    return mlp_block(cfg, p, x, lora), None


def layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  side: AttnSideInputs, layer_key=None,
                  kv_cache: Optional[tuple] = None, layer_idx: int = 0,
                  lora=None, return_aux: bool = False):
    """One pre-LN residual block (sequential or Falcon-parallel).  Returns
    ``out``, or ``(out, new_rows)`` with ``kv_cache``; ``lora`` is the
    layer's LoRA bundle (``_lora_add``).  ``return_aux`` returns ``(out,
    stats)`` with the MoE stats of the layer (None for a dense one).

    With a ``layer_key`` each residual branch takes dropout then
    drop-path (reference order: residual + drop_path(dropout(out)),
    transformer.py:717-734) at ``layer_idx``'s rates: the parallel block
    one mask on ``attn_out + mlp_out`` (salt 2), the sequential block one
    per branch (salts 2 and 3), drop-path at salt + 2."""
    hidden_rate, path_rate = drop.layer_rates(cfg, layer_idx)

    def branch_drop(out, salt):
        if layer_key is None:
            return out
        out = drop.dropout(out, hidden_rate, drop.fold_in(layer_key, salt),
                           seq_slices(cfg, out))
        return drop.drop_path(out, path_rate,
                              drop.fold_in(layer_key, salt + 2))

    residual = x
    h1 = norm_apply(cfg.norm_type, x, p["input_norm"], cfg.norm_eps,
                    impl=cfg.norm_impl)
    new_rows = None
    if kv_cache is not None:
        attn_out, new_rows = attention_block(cfg, p["attn"], h1, side,
                                             kv_cache=kv_cache, lora=lora)
    else:
        attn_out = attention_block(cfg, p["attn"], h1, side, layer_key,
                                   lora=lora)
    if cfg.parallel_attn:
        mlp_in = h1
        if cfg.parallel_layernorm:
            mlp_in = norm_apply(cfg.norm_type, x, p["mlp_norm"], cfg.norm_eps,
                                impl=cfg.norm_impl)
        mlp_out, aux = mlp_dispatch(cfg, p["mlp"], mlp_in, lora)
        result = residual + branch_drop(attn_out + mlp_out, 2)
    else:
        x = residual + branch_drop(attn_out, 2)
        h2 = norm_apply(cfg.norm_type, x, p["post_attn_norm"], cfg.norm_eps,
                        impl=cfg.norm_impl)
        mlp_out, aux = mlp_dispatch(cfg, p["mlp"], h2, lora)
        result = x + branch_drop(mlp_out, 3)
    if kv_cache is not None:
        return result, new_rows
    if return_aux:
        return result, aux
    return result


# what the selective policy keeps: the matmuls' outputs (a 3-D ``x @ w``
# reaches autograd as ``aten.mm`` on a view; the LoRA epilogue's two
# products too), and under int8 training matmuls the int32 products and
# the int8 operands with their scales (JAX saves the int8 dot, and a
# ``custom_vjp`` keeps its residuals)
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten._int_mm.default,
              torch.ops.megatron_llm_tpu_torch.int8_operands.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The selective policy: keep ``_SAVED_OPS``' outputs, recompute the
    rest (norms, RoPE, attention, activations, int8 epilogues)."""
    if op in _SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_runner(cfg: ModelConfig):
    """``run(fn, *args)`` for one layer under ``cfg.recompute``."""
    if cfg.recompute not in ("none", "selective", "full"):
        raise ValueError(f"unknown recompute {cfg.recompute!r} "
                         "(want 'none'|'selective'|'full')")
    if cfg.recompute == "none" or not torch.is_grad_enabled():
        return lambda fn, *args: fn(*args)
    kwargs = {"use_reentrant": False}
    if cfg.recompute == "selective":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return lambda fn, *args: checkpoint(fn, *args, **kwargs)


def _layer_arenas(arenas, n: int) -> list:
    """Each layer's ``{target: {"a", "b"}}`` slices of layer-stacked arenas
    (``[None] * n`` without), one ``unbind`` per leaf as in
    ``unstack_layers``: a trained factor's grads then join once."""
    if arenas is None:
        return [None] * n
    return unstack_layers(arenas)


def stack_forward(cfg: ModelConfig, stacked: Params, x: torch.Tensor,
                  side: AttnSideInputs, key=None, lora=None,
                  layer_offset: int = 0, return_aux: bool = False):
    """All layers, in order, each checkpointed as ``cfg.recompute`` says
    when autograd is on.  ``key`` (the stack's ``DropoutKey``, or None for
    no dropout) is folded with each layer's index, as JAX's scan does.
    ``lora`` is ``(arenas, mask)``: layer-stacked factors, which may
    require grad (LoRA finetuning), and the per-row mask.
    ``layer_offset`` is the global index of the first layer (a pipeline
    chunk's), which keeps the LIMA and drop-path ramps global.
    ``return_aux`` returns ``(hidden, aux)``: the MoE stats summed over
    the layers (``models/moe.py``), a 0 scalar for a dense model."""
    run = _layer_runner(cfg)
    arenas, mask = lora if lora is not None else (None, None)

    def layer(h, p, layer_key, idx, factors):
        layer_lora = None if factors is None else (factors, mask)
        return layer_forward(cfg, p, h, side, layer_key, layer_idx=idx,
                             lora=layer_lora, return_aux=True)

    aux = None
    layers = unstack_layers(stacked)
    for i, (p, factors) in enumerate(zip(
            layers, _layer_arenas(arenas, len(layers)))):
        layer_key = None if key is None else drop.fold_in(key, i)
        x, stats = run(layer, x, p, layer_key, layer_offset + i, factors)
        if stats is not None:
            aux = stats if aux is None else \
                {k: aux[k] + stats[k] for k in aux}
    if not return_aux:
        return x
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def stack_forward_cached(cfg: ModelConfig, stacked: Params, x: torch.Tensor,
                         side: AttnSideInputs,
                         k_cache,  # [L, b, nkv, max_len, d] or int8 dict
                         v_cache, cache_len, lora=None):
    """All layers threading the stacked KV cache: layer ``i`` writes its
    new rows into layer ``i`` of each cache (both leaves of the int8
    ``{"q", "scale"}`` form) in place.  Returns ``(hidden, k_cache,
    v_cache)``; the caller advances ``cache_len``.  ``lora`` is ``(arenas,
    mask)``: layer-stacked arenas (``ops/lora.make_arenas``) and the
    per-row mask, each layer taking its arena slice."""
    def layer_view(cache, i):
        if isinstance(cache, dict):
            return {k: v[i] for k, v in cache.items()}
        return cache[i]

    arenas, mask = lora if lora is not None else (None, None)
    layers = unstack_layers(stacked)
    fsdp_specs = _fsdp_layer_specs(cfg, stacked)
    mesh = current_mesh()
    pp_group, pp, stage = axis_info("pp")
    for turn in range(pp):
        if turn == stage:
            for i, (p, factors) in enumerate(zip(
                    layers, _layer_arenas(arenas, len(layers)))):
                if fsdp_specs is not None:
                    p = fsdp_whole(p, fsdp_specs, mesh)
                layer_lora = None if factors is None else (factors, mask)
                x, _ = layer_forward(cfg, p, x, side,
                                     kv_cache=(layer_view(k_cache, i),
                                               layer_view(v_cache, i),
                                               cache_len),
                                     lora=layer_lora)
        if turn < pp - 1:
            x = mappings.ppermute(x, pp_group, [(turn, turn + 1)])
    if pp > 1:
        # the last stage's hidden state to every stage
        x = mappings.all_reduce(x if stage == pp - 1
                                else torch.zeros_like(x), pp_group)
    return x, k_cache, v_cache


def _fsdp_layer_specs(cfg: ModelConfig, stacked: Params):
    """One layer's serving specs (the stacked specs less the layer axis,
    quantized leaves mirrored) where the current mesh splits residency
    over fsdp; None otherwise."""
    mesh = current_mesh()
    if mesh is None or mesh.size("fsdp") == 1:
        return None
    from ..ops.quant import quantize_specs
    from .sharding import FSDP, _layer_specs

    specs = quantize_specs(
        {"layers": _layer_specs(cfg, None, mesh.size("tp"),
                                fsdp_axes=FSDP)},
        {"layers": stacked})["layers"]
    return tree_map(lambda spec: spec[1:], specs)


def rope_tables(cfg: ModelConfig, dtype=torch.float32, device=None):
    if cfg.position_embedding_type != PositionEmbeddingType.ROTARY:
        return None, None
    return precompute_rope_freqs(
        cfg.head_dim,
        cfg.max_position_embeddings,
        theta=cfg.rope_theta,
        scaling_factor=cfg.rope_scaling_factor,
        scaling_type=cfg.rope_scaling_type,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_positions=cfg.rope_original_max_positions,
        beta_fast=cfg.rope_beta_fast,
        beta_slow=cfg.rope_beta_slow,
        attention_factor=cfg.rope_attention_factor,
        dtype=dtype,
        device=device,
    )
