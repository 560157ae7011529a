"""Decoder transformer stack (mirror of
``megatron_llm_tpu/models/transformer.py``).

Parameters keep the JAX package's stacked layout: a dict whose leaves
carry a leading layer axis ``[L, ...]`` (``x @ w`` with w ``[in, out]``),
so ``convert.params_from_jax`` is a plain leaf-for-leaf copy.  The stack is
a Python loop over layers in place of ``lax.scan``.

``stack_forward`` serves inference and training.  Under autograd each
layer runs inside ``torch.utils.checkpoint`` as ``cfg.recompute`` says:
``"full"`` recomputes the whole layer in the backward, ``"selective"``
saves the projection matmuls' outputs (``aten.mm``) and recomputes the
rest, as JAX's ``dots_with_no_batch_dims_saveable`` policy does, and
``"none"`` saves everything.  The policy changes memory and time, not the
numbers, with dropout on too: ``stack_forward`` takes the stack's
``DropoutKey`` and each layer folds in its index, so a recomputed layer
redraws the forward's masks from the same keys (``ops/dropout.py``).
Without a key the forward is deterministic.  Serving-quantized weights
(``ops/quant.py``) go through ``mm``; MoE layers and int8 training
matmuls belong to later slices and raise here.  ``stack_forward_cached``
takes the multi-tenant LoRA bundle (``ops/lora.py``): each targeted
projection gains its grouped epilogue right after the base product.
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
from ..ops.quant import is_quantized, mm
from ..ops.rope import apply_rope, precompute_rope_freqs

Params = dict


def proj(cfg: ModelConfig, x: torch.Tensor, w) -> torch.Tensor:
    """Projection matmul through ``ops/quant.mm``: a plain weight is
    ``x @ w`` (a large product, left to torch.matmul as the JAX package
    left it to XLA); a serving-quantized ``{"q", "scale"}`` weight is
    dequantized into the product."""
    if cfg.quantize_matmuls != "none" and not is_quantized(w):
        raise NotImplementedError(
            "quantize_matmuls='int8' (W8A8 training matmuls) is not ported "
            "yet (ROADMAP.md, Queue 1 item 12: the rest, int8 training "
            "matmul)")
    return mm(x, w)


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
                      device, num_layers: Optional[int] = None) -> Params:
    """All layers stacked on a leading axis; each layer is drawn on its
    own so the fp32 draw never holds more than one layer."""
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP.md, Queue 1: MoE)")
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
    if is_glu(cfg.activation):
        shapes[("mlp", "w_gate")] = ((h, ffn), std)
    shapes[("mlp", "w_up")] = ((h, ffn), std)
    shapes[("mlp", "w_down")] = ((ffn, h), out_std)
    layers: Params = {"attn": {}, "mlp": {}}
    for (group, name), (shape, s) in shapes.items():
        w = torch.empty((n,) + shape, dtype=dtype, device=device)
        for i in range(n):
            w[i] = _normal(shape, s, dtype, generator, device)
        layers[group][name] = w

    def zeros(size):
        return torch.zeros(n, size, dtype=dtype, device=device)

    if cfg.use_bias or cfg.qkv_bias:
        layers["attn"].update(bq=zeros(nq * d), bk=zeros(nkv * d),
                              bv=zeros(nkv * d))
    if cfg.use_bias:
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
    b, s, _ = x.shape
    d = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    q = _lora_add(proj(cfg, x, p["wq"]), x, lora, "wq")
    k = _lora_add(proj(cfg, x, p["wk"]), x, lora, "wk")
    v = _lora_add(proj(cfg, x, p["wv"]), x, lora, "wv")
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, nq, d)
    k = k.reshape(b, s, nkv, d)
    v = v.reshape(b, s, nkv, d)
    position_ids = side.position_ids
    if kv_cache is not None and position_ids is None:
        raise ValueError("kv_cache requires explicit position_ids "
                         "(forward_cached supplies them)")
    if cfg.position_embedding_type == PositionEmbeddingType.ROTARY:
        q = apply_rope(q, side.rope_cos, side.rope_sin, position_ids)
        k = apply_rope(k, side.rope_cos, side.rope_sin, position_ids)
    softmax_scale = 1.0 / (d ** 0.5)
    drop_key = None
    if layer_key is not None and cfg.attention_dropout > 0.0:
        drop_key = drop.fold_in(layer_key, 1)

    new_rows = None
    if kv_cache is not None:
        k_cache, v_cache, cache_len = kv_cache
        new_k = k.transpose(1, 2)               # [b, nkv, s, d]
        new_v = v.transpose(1, 2)
        cache_update(k_cache, new_k, cache_len)
        cache_update(v_cache, new_v, cache_len)
        new_rows = (new_k, new_v)
        if side.cache_is_empty and s > 1:
            ctx = attention(q, k.contiguous(), v.contiguous(),
                            impl=cfg.attention_impl, causal=True,
                            softmax_scale=softmax_scale)
        else:
            ctx = decode_attention(q, k_cache, v_cache, cache_len,
                                   softmax_scale=softmax_scale)
    else:
        ctx = attention(q, k.contiguous(), v.contiguous(),
                        impl=cfg.attention_impl, causal=side.causal,
                        segment_ids=side.segment_ids,
                        softmax_scale=softmax_scale,
                        dropout_rate=(0.0 if layer_key is None
                                      else cfg.attention_dropout),
                        dropout_key=drop_key, bias=side.attn_bias)
    ctx2d = ctx.reshape(b, s, nq * d)
    out = _lora_add(proj(cfg, ctx2d, p["wo"]), ctx2d, lora, "wo")
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
    out = _lora_add(proj(cfg, hidden, p["w_down"]), hidden, lora, "w_down")
    if "b_down" in p:
        out = out + p["b_down"]
    return out


def layer_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  side: AttnSideInputs, layer_key=None,
                  kv_cache: Optional[tuple] = None, layer_idx: int = 0,
                  lora=None):
    """One pre-LN residual block (sequential or Falcon-parallel).  Returns
    ``out``, or ``(out, new_rows)`` with ``kv_cache``; ``lora`` is the
    layer's LoRA bundle (``_lora_add``).

    With a ``layer_key`` each residual branch takes dropout then
    drop-path (reference order: residual + drop_path(dropout(out)),
    transformer.py:717-734) at ``layer_idx``'s rates: the parallel block
    one mask on ``attn_out + mlp_out`` (salt 2), the sequential block one
    per branch (salts 2 and 3), drop-path at salt + 2."""
    hidden_rate, path_rate = drop.layer_rates(cfg, layer_idx)

    def branch_drop(out, salt):
        if layer_key is None:
            return out
        out = drop.dropout(out, hidden_rate, drop.fold_in(layer_key, salt))
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
        attn_out = attention_block(cfg, p["attn"], h1, side, layer_key)
    if cfg.parallel_attn:
        mlp_in = h1
        if cfg.parallel_layernorm:
            mlp_in = norm_apply(cfg.norm_type, x, p["mlp_norm"], cfg.norm_eps,
                                impl=cfg.norm_impl)
        result = residual + branch_drop(
            attn_out + mlp_block(cfg, p["mlp"], mlp_in, lora), 2)
    else:
        x = residual + branch_drop(attn_out, 2)
        h2 = norm_apply(cfg.norm_type, x, p["post_attn_norm"], cfg.norm_eps,
                        impl=cfg.norm_impl)
        result = x + branch_drop(mlp_block(cfg, p["mlp"], h2, lora), 3)
    if kv_cache is not None:
        return result, new_rows
    return result


def _save_matmuls(ctx, op, *args, **kwargs):
    """The selective policy: keep the projection matmuls' outputs (a 3-D
    ``x @ w`` reaches autograd as ``aten.mm`` on a view), recompute the
    rest (norms, RoPE, attention, activations)."""
    if op is torch.ops.aten.mm.default:
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


def stack_forward(cfg: ModelConfig, stacked: Params, x: torch.Tensor,
                  side: AttnSideInputs, key=None) -> torch.Tensor:
    """All layers, in order, each checkpointed as ``cfg.recompute`` says
    when autograd is on.  ``key`` (the stack's ``DropoutKey``, or None for
    no dropout) is folded with each layer's index, as JAX's scan does."""
    run = _layer_runner(cfg)

    def layer(h, p, layer_key, idx):
        return layer_forward(cfg, p, h, side, layer_key, layer_idx=idx)

    for i, p in enumerate(unstack_layers(stacked)):
        layer_key = None if key is None else drop.fold_in(key, i)
        x = run(layer, x, p, layer_key, i)
    return x


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
    for i, p in enumerate(unstack_layers(stacked)):
        layer_lora = None
        if arenas is not None:
            layer_lora = ({t: {"a": f["a"][i], "b": f["b"][i]}
                           for t, f in arenas.items()}, mask)
        x, _ = layer_forward(cfg, p, x, side,
                             kv_cache=(layer_view(k_cache, i),
                                       layer_view(v_cache, i), cache_len),
                             lora=layer_lora)
    return x, k_cache, v_cache


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
