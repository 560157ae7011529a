"""Encoder and encoder-decoder models: BERT and T5 (mirror of
``megatron_llm_tpu/models/encdec.py``).

- ``BertModel`` (reference megatron/model/bert_model.py): a bidirectional
  encoder, the pooler, the MLM head (dense → gelu → LayerNorm → the tied
  embedding's logits + a bias) and the binary (NSP) head; the loss is the
  masked-LM cross-entropy plus the sentence-pair one.
- ``T5Model`` (megatron/model/t5_model.py): a shared embedding, an encoder
  and a decoder with cross-attention, learned absolute positions, tied
  logits + a bias.

Both reuse the decoder stack of ``models/transformer.py``: the encoder is
``stack_forward`` with ``causal=False`` and the padding as segment ids
(pads in segment 0, content in 1), so ``attention_impl="flash"`` takes the
flash kernels in their non-causal mode; the T5 decoder adds a
cross-attention block between self-attention and MLP, each layer run
under ``cfg.recompute`` as ``stack_forward`` runs its layers.  Cross
attention is the JAX package's einsum with an additive ``-inf`` bias over
the encoder's pads, outside any kernel, as there.

Parameters are the JAX package's trees (``convert.params_from_jax``
carries them leaf for leaf; the T5 ``cross`` subtree is stacked per
decoder layer), drawn here from a ``torch.Generator``.  Dropout is on when
a ``DropoutKey`` is given and ``deterministic`` is False, with JAX's key
chain: the stack folds in the layer, the T5 decoder's three residual
branches take salts 2, 3 and 4.

Under a current mesh with tp > 1 (``bert_param_specs``,
``t5_param_specs``; JAX ``encdec.py:367-421``) the stacks run the
decoder's column/row-parallel blocks, the word table is vocab-parallel
(``model.vocab_parallel_embed``), cross-attention is split like
self-attention, and the tied heads are column-parallel products giving
this rank's vocabulary block of the logits (with its block of the logit
bias) for ``vocab_parallel_cross_entropy``.  The small heads (BERT's MLM
dense and norm, the pooler, the binary head) stay replicated, as in the
reference.  Sequence parallelism is not wired through these families
(ROADMAP.md, Queue 1 item 9's remainder).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops import dropout as drop
from ..ops.attention import attention
from ..ops.norms import norm_apply, norm_init
from ..parallel import mappings
from ..parallel.cross_entropy import (
    cross_entropy,
    masked_mean_loss,
    vocab_parallel_cross_entropy,
)
from ..utils.tree import tree_map
from .model import default_device, vocab_parallel_embed
from .transformer import (
    AttnSideInputs,
    Params,
    _layer_runner,
    _normal,
    attention_block,
    init_stack_params,
    local_kv_heads,
    mlp_block,
    proj,
    stack_forward,
    tp_layout,
    unstack_layers,
)


def _check_family(cfg: ModelConfig) -> None:
    assert not cfg.parallel_attn, "BERT/T5 use sequential residual blocks"
    assert cfg.num_experts == 0, (
        "MoE is not plumbed through the encoder stacks (the aux "
        "load-balance loss would be silently dropped)")


def _generator(seed: int, device):
    """``(generator, device)``; no generator on the ``meta`` device, which
    gives shapes and dtypes alone (a checkpoint template)."""
    device = default_device(device)
    if device.type == "meta":
        return None, device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen, device


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _pad_segments(pad_mask: torch.Tensor) -> torch.Tensor:
    """``[b, s]`` 1/0 pad mask → int32 segment ids, pads in segment 0 and
    content in segment 1, so content never attends to padding (the one
    place the mask is cast; the kernel wrapper takes it as it is)."""
    return pad_mask.to(torch.int32).contiguous()


def _tp(cfg: ModelConfig) -> tuple:
    """``(group, size, index)`` of tp; the families run no sequence
    parallelism."""
    group, tp, rank, sp = tp_layout(cfg)
    if sp:
        raise NotImplementedError(
            "sequence parallelism in the BERT / T5 / biencoder stacks is "
            "not ported yet (ROADMAP.md, Queue 1 item 9's remainder)")
    return group, tp, rank


def _word_lookup(cfg: ModelConfig, word: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    group, tp, rank = _tp(cfg)
    if tp > 1:
        return vocab_parallel_embed(word, tokens, group, rank, False)
    return word[tokens]


def _tied_logits(cfg: ModelConfig, x: torch.Tensor, word: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``x @ word.T`` (fp32) + the logit bias; under tp this rank's
    vocabulary block, a column-parallel product."""
    group, tp, _ = _tp(cfg)
    if tp > 1:
        x = mappings.copy_to_tensor_region(x, group)
    return (x @ word.T).float() + bias


def _lm_cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    group, tp, _ = _tp(cfg)
    if tp > 1:
        return vocab_parallel_cross_entropy(logits, labels, group,
                                            vocab_size=cfg.vocab_size)
    return cross_entropy(logits, labels, vocab_size=cfg.vocab_size)


def _stack_key(base_rng, deterministic: bool):
    """The stack's ``DropoutKey``, or None when nothing is dropped."""
    return None if deterministic else base_rng


def _encoder_side(pad_mask: Optional[torch.Tensor]) -> AttnSideInputs:
    return AttnSideInputs(
        segment_ids=None if pad_mask is None else _pad_segments(pad_mask),
        causal=False)


def encoder_forward(cfg: ModelConfig, stacked: Params, x: torch.Tensor,
                    pad_mask: Optional[torch.Tensor], base_rng=None,
                    deterministic: bool = True,
                    layer_offset: int = 0) -> torch.Tensor:
    """The bidirectional stack (no RoPE: BERT and T5 use absolute
    positions), each layer under ``cfg.recompute``; ``layer_offset`` is
    the global index of its first layer (a pipeline stage's)."""
    return stack_forward(cfg, stacked, x, _encoder_side(pad_mask),
                         _stack_key(base_rng, deterministic),
                         layer_offset=layer_offset)


# ---------------------------------------------------------------------------
# BERT (reference: megatron/model/bert_model.py)
# ---------------------------------------------------------------------------


def _init_bert(cfg: ModelConfig, gen, device, tp: int = 1) -> Params:
    _check_family(cfg)
    h, dtype, std = cfg.hidden_size, cfg.dtype, cfg.init_method_std
    v = cfg.padded_vocab_size(tp)

    def normal(shape):
        return _normal(shape, std, dtype, gen, device)

    return {
        "embedding": {
            "word": normal((v, h)),
            "position": normal((cfg.max_position_embeddings, h)),
            "tokentype": normal((max(cfg.tokentype_size, 2), h)),
        },
        "embed_norm": norm_init(cfg.norm_type, h, dtype, device),
        "layers": init_stack_params(cfg, gen, device),
        "final_norm": norm_init(cfg.norm_type, h, dtype, device),
        # the MLM transform (BertLMHead: dense, gelu, LN, tied logits + bias)
        "lm_head": {
            "dense": normal((h, h)),
            "dense_bias": _zeros((h,), dtype, device),
            "norm": norm_init(cfg.norm_type, h, dtype, device),
            "bias": _zeros((v,), torch.float32, device),
        },
        # pooler + binary (NSP) head (bert_model.py pooler / binary_head)
        "pooler": {"w": normal((h, h)), "b": _zeros((h,), dtype, device)},
        "binary_head": {"w": normal((h, 2)),
                        "b": _zeros((2,), dtype, device)},
    }


def init_bert_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                     tp: int = 1) -> Params:
    """BERT's parameters with the JAX package's shapes and distributions,
    drawn on ``device`` (default ``cuda``) from ``seed``."""
    gen, device = _generator(seed, device)
    return _init_bert(cfg, gen, device, tp)


def bert_embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               tokentype_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Word + position + tokentype embeddings through the embedding norm
    (``params`` needs ``embedding`` and ``embed_norm``)."""
    b, s = tokens.shape
    emb = params["embedding"]
    if tokentype_ids is None:
        tokentype_ids = torch.zeros((b, s), dtype=torch.long,
                                    device=tokens.device)
    pos = torch.arange(s, device=tokens.device)[None, :]
    x = _word_lookup(cfg, emb["word"], tokens) + emb["position"][pos] \
        + emb["tokentype"][tokentype_ids]
    return norm_apply(cfg.norm_type, x, params["embed_norm"], cfg.norm_eps,
                      impl=cfg.norm_impl)


def _bert_tail(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """The encoder's output through the final norm, and the pooled [CLS]."""
    x = norm_apply(cfg.norm_type, x, params["final_norm"], cfg.norm_eps,
                   impl=cfg.norm_impl)
    pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"]
                        + params["pooler"]["b"])
    return x, pooled


def bert_encode(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                pad_mask: torch.Tensor,
                tokentype_ids: Optional[torch.Tensor] = None,
                rng=None, deterministic: bool = True):
    """The shared BERT trunk → ``(hidden [b, s, h], pooled [CLS] [b, h])``,
    used by the pretraining heads, the biencoder and the downstream
    tasks."""
    x = bert_embed(cfg, params, tokens, tokentype_ids)
    x = encoder_forward(cfg, params["layers"], x, pad_mask, rng,
                        deterministic)
    return _bert_tail(cfg, params, x)


def _bert_heads(cfg: ModelConfig, params: Params, x: torch.Tensor,
                pooled: torch.Tensor):
    head = params["lm_head"]
    t = F.gelu(x @ head["dense"] + head["dense_bias"], approximate="tanh")
    t = norm_apply(cfg.norm_type, t, head["norm"], cfg.norm_eps,
                   impl=cfg.norm_impl)
    mlm_logits = _tied_logits(cfg, t, params["embedding"]["word"],
                              head["bias"])
    binary_logits = (pooled @ params["binary_head"]["w"]
                     + params["binary_head"]["b"]).float()
    return mlm_logits, binary_logits


def bert_forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 pad_mask: torch.Tensor,
                 tokentype_ids: Optional[torch.Tensor] = None,
                 rng=None, deterministic: bool = True):
    """→ ``(mlm_logits [b, s, v] fp32, binary_logits [b, 2] fp32)``."""
    x, pooled = bert_encode(cfg, params, tokens, pad_mask, tokentype_ids,
                            rng, deterministic)
    return _bert_heads(cfg, params, x, pooled)


def _bert_loss_of(cfg: ModelConfig, mlm_logits, bin_logits, batch: dict):
    lm = _lm_cross_entropy(cfg, mlm_logits, batch["labels"])
    total = masked_mean_loss(lm, batch["loss_mask"], batch.get("loss_denom"))
    if "is_random" in batch:
        nsp = cross_entropy(bin_logits[:, None, :],
                            batch["is_random"][:, None], vocab_size=2)
        total = total + torch.mean(nsp)
    return total


def bert_loss(cfg: ModelConfig, params: Params, batch: dict,
              rng=None, deterministic: bool = True):
    """Masked-LM + NSP loss (reference bert_model.py
    post_language_model_processing + pretrain_bert.py forward_step)."""
    return _bert_loss_of(cfg, *bert_forward(
        cfg, params, batch["tokens"], batch["pad_mask"],
        batch.get("tokentype_ids"), rng, deterministic), batch)


def bert_head_loss(cfg: ModelConfig, params: Params, x: torch.Tensor,
                   batch: dict):
    """``bert_loss`` from the encoder stack's output ``x`` on (the last
    pipeline stage's part: ``params`` needs the embedding, the final norm
    and the heads)."""
    return _bert_loss_of(cfg, *_bert_heads(cfg, params,
                                           *_bert_tail(cfg, params, x)),
                         batch)


# ---------------------------------------------------------------------------
# T5 (reference: megatron/model/t5_model.py)
# ---------------------------------------------------------------------------


def init_t5_decoder_layer_extras(cfg: ModelConfig, gen, device) -> Params:
    """One decoder layer's cross-attention weights and their pre-norm."""
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.kv_heads
    dtype, std = cfg.dtype, cfg.init_method_std
    out_std = (std / (2.0 * cfg.num_layers) ** 0.5
               if cfg.use_scaled_init else std)
    return {
        "norm": norm_init(cfg.norm_type, h, dtype, device),
        "wq": _normal((h, nq * d), std, dtype, gen, device),
        "wk": _normal((h, nkv * d), std, dtype, gen, device),
        "wv": _normal((h, nkv * d), std, dtype, gen, device),
        "wo": _normal((nq * d, h), out_std, dtype, gen, device),
    }


def num_decoder_layers(cfg: ModelConfig) -> int:
    return cfg.num_decoder_layers or cfg.num_layers


def init_t5_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                   tp: int = 1) -> Params:
    """T5's parameters (the JAX tree: ``cross`` stacked ``[nd, ...]``)
    drawn on ``device`` (default ``cuda``) from ``seed``."""
    _check_family(cfg)
    gen, device = _generator(seed, device)
    h, dtype, std = cfg.hidden_size, cfg.dtype, cfg.init_method_std
    v = cfg.padded_vocab_size(tp)
    nd = num_decoder_layers(cfg)
    word = _normal((v, h), std, dtype, gen, device)
    position = _normal((cfg.max_position_embeddings, h), std, dtype, gen,
                       device)
    encoder = init_stack_params(cfg, gen, device)
    per_layer = [init_t5_decoder_layer_extras(cfg, gen, device)
                 for _ in range(nd)]

    cross = tree_map(lambda *leaves: torch.stack(leaves), *per_layer)
    return {
        "embedding": {"word": word, "position": position},
        "encoder": encoder,
        "decoder": init_stack_params(cfg, gen, device, num_layers=nd),
        "cross": cross,
        "enc_norm": norm_init(cfg.norm_type, h, dtype, device),
        "dec_norm": norm_init(cfg.norm_type, h, dtype, device),
        "lm_head_bias": _zeros((v,), torch.float32, device),
    }


def cross_attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          enc_out: torch.Tensor,
                          enc_pad_mask: Optional[torch.Tensor]):
    """Decoder queries over the encoder's outputs (t5_model.py decoder
    cross-attention; the mask is the encoder's padding alone).  The einsum
    path with an additive ``-inf`` bias, as JAX computes it."""
    group, tp, rank = _tp(cfg)
    if tp > 1:
        x = mappings.copy_to_tensor_region(x, group)
        enc_out = mappings.copy_to_tensor_region(enc_out, group)
    b, s, _ = x.shape
    d = cfg.head_dim
    se = enc_out.shape[1]
    q = proj(cfg, x, p["wq"])
    k = proj(cfg, enc_out, p["wk"])
    nq, nkv = q.shape[-1] // d, k.shape[-1] // d  # this rank's heads
    q = q.reshape(b, s, nq, d)
    k = k.reshape(b, se, nkv, d)
    v = proj(cfg, enc_out, p["wv"]).reshape(b, se, nkv, d)
    k, v, _ = local_kv_heads(cfg, k, v, nq, tp, rank)
    bias = None
    if enc_pad_mask is not None:
        bias = torch.where(enc_pad_mask[:, None, None, :] > 0, 0.0,
                           float("-inf")).float()
    ctx = attention(q, k, v, impl="dot", causal=False, bias=bias,
                    softmax_scale=1.0 / (d ** 0.5))
    out = proj(cfg, ctx.reshape(b, s, nq * d), p["wo"])
    if tp > 1:
        out = mappings.reduce_from_tensor_region(out, group)
    return out


def t5_decoder_forward(cfg: ModelConfig, stacked: Params, cross: Params,
                       x: torch.Tensor, enc_out: torch.Tensor,
                       dec_pad_mask: Optional[torch.Tensor],
                       enc_pad_mask: Optional[torch.Tensor],
                       base_rng=None, deterministic: bool = True):
    """The decoder stack: per layer self-attention (causal, the pads as
    segments) → cross-attention → MLP, each a pre-norm residual with hidden
    dropout at salts 2, 3 and 4 of the layer's key."""
    side = AttnSideInputs(
        segment_ids=(None if dec_pad_mask is None
                     else _pad_segments(dec_pad_mask)),
        causal=True)
    key = _stack_key(base_rng, deterministic)
    run = _layer_runner(cfg)

    def layer(h, lp, cp, layer_key):
        def branch(out, salt):
            if layer_key is None:
                return out
            return drop.dropout(out, cfg.hidden_dropout,
                                drop.fold_in(layer_key, salt))

        h1 = norm_apply(cfg.norm_type, h, lp["input_norm"], cfg.norm_eps,
                        impl=cfg.norm_impl)
        h = h + branch(attention_block(cfg, lp["attn"], h1, side, layer_key),
                       2)
        c = norm_apply(cfg.norm_type, h, cp["norm"], cfg.norm_eps,
                       impl=cfg.norm_impl)
        h = h + branch(cross_attention_block(cfg, cp, c, enc_out,
                                             enc_pad_mask), 3)
        m = norm_apply(cfg.norm_type, h, lp["post_attn_norm"], cfg.norm_eps,
                       impl=cfg.norm_impl)
        return h + branch(mlp_block(cfg, lp["mlp"], m), 4)

    for i, (lp, cp) in enumerate(zip(unstack_layers(stacked),
                                     unstack_layers(cross))):
        layer_key = None if key is None else drop.fold_in(key, i)
        x = run(layer, x, lp, cp, layer_key)
    return x


def t5_embed(cfg: ModelConfig, params: Params,
             tokens: torch.Tensor) -> torch.Tensor:
    """The shared word embedding plus the learned positions."""
    emb = params["embedding"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return _word_lookup(cfg, emb["word"], tokens) + emb["position"][pos]


def _t5_logits(cfg: ModelConfig, params: Params,
               dec: torch.Tensor) -> torch.Tensor:
    dec = norm_apply(cfg.norm_type, dec, params["dec_norm"], cfg.norm_eps,
                     impl=cfg.norm_impl)
    return _tied_logits(cfg, dec, params["embedding"]["word"],
                        params["lm_head_bias"])


def t5_forward(cfg: ModelConfig, params: Params, enc_tokens: torch.Tensor,
               dec_tokens: torch.Tensor,
               enc_pad_mask: Optional[torch.Tensor] = None,
               dec_pad_mask: Optional[torch.Tensor] = None,
               rng=None, deterministic: bool = True) -> torch.Tensor:
    """→ decoder logits ``[b, s_dec, padded_vocab]`` fp32."""
    enc_rng = dec_rng = None
    if rng is not None:
        enc_rng, dec_rng = drop.split(rng)
    enc = encoder_forward(cfg, params["encoder"],
                          t5_embed(cfg, params, enc_tokens), enc_pad_mask,
                          enc_rng, deterministic)
    enc = norm_apply(cfg.norm_type, enc, params["enc_norm"], cfg.norm_eps,
                     impl=cfg.norm_impl)
    dec = t5_decoder_forward(cfg, params["decoder"], params["cross"],
                             t5_embed(cfg, params, dec_tokens), enc,
                             dec_pad_mask, enc_pad_mask, dec_rng,
                             deterministic)
    return _t5_logits(cfg, params, dec)


def _t5_loss_of(cfg: ModelConfig, logits: torch.Tensor, batch: dict):
    per_tok = _lm_cross_entropy(cfg, logits, batch["labels"])
    return masked_mean_loss(per_tok, batch["loss_mask"],
                            batch.get("loss_denom"))


def t5_loss(cfg: ModelConfig, params: Params, batch: dict,
            rng=None, deterministic: bool = True):
    return _t5_loss_of(cfg, t5_forward(
        cfg, params, batch["enc_tokens"], batch["dec_tokens"],
        batch.get("enc_pad_mask"), batch.get("dec_pad_mask"), rng,
        deterministic), batch)


def t5_head_loss(cfg: ModelConfig, params: Params, dec: torch.Tensor,
                 batch: dict):
    """``t5_loss`` from the decoder stack's output ``dec`` on (the last
    pipeline stage's part: ``params`` needs the embedding, ``dec_norm``
    and ``lm_head_bias``)."""
    return _t5_loss_of(cfg, _t5_logits(cfg, params, dec), batch)


# ---------------------------------------------------------------------------
# Tensor-parallel specs (JAX encdec.py:367-421): the families train through
# the decoder's column / row / vocab layout
# ---------------------------------------------------------------------------


def bert_param_specs(cfg: ModelConfig, parallel) -> Params:
    """Specs of ``init_bert_params``: the vocab-parallel embedding and the
    column/row-parallel encoder; the small heads (MLM dense, pooler, NSP)
    replicated as in the reference (plain ``get_linear_layer``)."""
    from .sharding import P, _layer_specs, norm_specs

    return {
        "embedding": {
            "word": P("tp", None),
            "position": P(None, None),
            "tokentype": P(None, None),
        },
        "embed_norm": norm_specs(cfg),
        "layers": _layer_specs(cfg, None, parallel.tensor_parallel),
        "final_norm": norm_specs(cfg),
        "lm_head": {
            "dense": P(None, None),
            "dense_bias": P(None),
            "norm": norm_specs(cfg),
            "bias": P("tp"),  # the vocab-sharded tied logits' bias
        },
        "pooler": {"w": P(None, None), "b": P(None)},
        "binary_head": {"w": P(None, None), "b": P(None)},
    }


def t5_param_specs(cfg: ModelConfig, parallel) -> Params:
    """Specs of ``init_t5_params``: both stacks column/row-parallel,
    cross-attention split like self-attention."""
    from .sharding import P, _layer_specs, kv_shard_axes, norm_specs

    kv_tp = kv_shard_axes(cfg, parallel.tensor_parallel)
    return {
        "embedding": {
            "word": P("tp", None),
            "position": P(None, None),
        },
        "encoder": _layer_specs(cfg, None, parallel.tensor_parallel),
        "decoder": _layer_specs(cfg, None, parallel.tensor_parallel),
        "cross": {
            "norm": norm_specs(cfg),  # [nd, h] leaves; unsharded
            "wq": P(None, None, "tp"),
            "wk": P(None, None, kv_tp),
            "wv": P(None, None, kv_tp),
            "wo": P(None, "tp", None),
        },
        "enc_norm": norm_specs(cfg),
        "dec_norm": norm_specs(cfg),
        "lm_head_bias": P("tp"),
    }

