"""Attention math (mirror of ``megatron_llm_tpu/ops/attention.py``).

Activations are ``[batch, seq, heads, head_dim]``; GQA groups are folded
by reshaping Q to ``[b, s, kv_heads, group, d]`` so K/V are never tiled
up.  ``attention`` dispatches ``impl="flash"`` to the flash-attention
autograd Function (the CUDA forward and backward kernels on CUDA tensors,
their plain versions on CPU tensors), so the same call serves inference
and training, and ``impl="dot"`` to the einsum path.  ``decode_attention``
takes the flash-decode kernel (K8, or K9 over an int8 cache) when
``decode_kernel_eligible`` says the CUDA kernel takes the operands, else
the einsum path, as the JAX package takes its Pallas kernels only on a
TPU.  ``paged_decode_attention`` reads one layer of the block pool through
block tables: K10/K11 where ``paged_decode_kernel_eligible`` says so, else
the dense gather and ``decode_attention``.

Not in this slice: ring attention (context parallelism) and sharded
dispatch under a mesh.
"""

from __future__ import annotations

import math

import torch

from .dropout import dropout
from .kv_quant import is_quantized_cache


def decode_kernel_eligible(q, k_cache) -> bool:
    """The port's predicate for the decode fast path: one new token per
    row (q ``[b, 1, h, d]``) on CUDA tensors the flash-decode kernel takes
    (dtype, head size, GQA group): K8, or K9 for an int8 cache.  JAX's
    predicate (``d % 128``, ``max_len % 128``, a TPU) is Mosaic's, not the
    function's."""
    from ..kernels.flash_decode import int8_kernel_takes, kernel_takes

    if q.shape[1] != 1:
        return False
    if is_quantized_cache(k_cache):
        return int8_kernel_takes(q[:, 0], k_cache["q"])
    return kernel_takes(q[:, 0], k_cache)


def paged_decode_kernel_eligible(q, k_pool) -> bool:
    """The port's predicate for the paged kernels: one new token per row on
    CUDA tensors that K10 (a pool in q's dtype) or K11 (an int8 pool)
    takes, with a power-of-two block.  The TPU predicate's ``block % 128``
    is a Mosaic tiling rule; the engine's 64-token blocks qualify here."""
    from ..kernels.flash_decode import paged_kernel_takes

    pool = k_pool["q"] if is_quantized_cache(k_pool) else k_pool
    return q.shape[1] == 1 and paged_kernel_takes(q[:, 0], pool)


def make_causal_mask(seq_q: int, seq_k: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, seq_q, seq_k] (0 keep / -inf drop)."""
    i = torch.arange(seq_q, device=device)[:, None]
    j = torch.arange(seq_k, device=device)[None, :]
    keep = j <= (i + (seq_k - seq_q))
    zero = torch.zeros((), dtype=dtype, device=device)
    ninf = torch.full((), float("-inf"), dtype=dtype, device=device)
    return torch.where(keep, zero, ninf)[None, None]


def _decode_keep_mask(cache_len, s: int, max_len: int, device):
    """[b or 1, s, max_len] keep-mask: column j is visible to new token i
    when j <= cache_len + i (cache_len an int, a 0-d or a [b] tensor).  An
    int stays on the host: a tensor made from it would be a copy from
    pageable memory, which waits for the stream at every layer."""
    i = torch.arange(s, device=device)
    j = torch.arange(max_len, device=device)
    if isinstance(cache_len, int):
        return (j[None, :] <= (i[:, None] + cache_len))[None]
    cl = torch.as_tensor(cache_len, device=device).to(torch.long)
    if cl.ndim == 0:
        return (j[None, :] <= (cl + i[:, None]))[None]
    return j[None, None, :] <= (cl[:, None, None] + i[None, :, None])


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     softmax_scale: float | None = None) -> torch.Tensor:
    """Incremental-decode attention over a head-major KV cache.

    q ``[b, s, n_heads, d]`` (the new tokens), caches ``[b, kv_heads,
    max_len, d]`` (or int8 ``{"q", "scale"}`` pairs) already holding the
    new rows, ``cache_len`` the position of q's first token (scalar or
    ``[b]``).  Columns past ``cache_len + i`` hold garbage and are masked.

    An int8 cache off the kernel takes JAX's scale-folded einsum, in its
    order: the scores times the k scales times the softmax scale, then the
    probabilities times the v scales, cast to q's dtype."""
    kv_q = is_quantized_cache(k_cache)
    b, s, n_heads, d = q.shape
    _, kv_heads, max_len, _ = (k_cache["q"] if kv_q else k_cache).shape
    group = n_heads // kv_heads
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    if decode_kernel_eligible(q, k_cache):
        from ..kernels.flash_decode import flash_decode, flash_decode_int8

        lens = torch.as_tensor(cache_len, device=q.device) + 1
        if kv_q:
            out = flash_decode_int8(
                q[:, 0].contiguous(), k_cache["q"], k_cache["scale"],
                v_cache["q"], v_cache["scale"], lens,
                softmax_scale=softmax_scale)
        else:
            out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, lens,
                               softmax_scale=softmax_scale)
        return out[:, None]
    # [b, kv, group·s, d]: fold the GQA group and the new-token dim
    qg = q.reshape(b, s, kv_heads, group, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, kv_heads, group * s, d)
    keep = _decode_keep_mask(cache_len, s, max_len, q.device)
    keep = keep.repeat(1, group, 1)                # [b or 1, g·s, max_len]
    if kv_q:
        scores = torch.einsum("bhqd,bhkd->bhqk", qg.float(),
                              k_cache["q"].float())
        scores = scores * k_cache["scale"][:, :, None, :] * softmax_scale
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", qg.float(),
                              k_cache.float()) * softmax_scale
    scores = scores.masked_fill(~keep[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if kv_q:
        probs = (probs * v_cache["scale"][:, :, None, :]).to(q.dtype)
        v = v_cache["q"].to(q.dtype)
    else:
        probs, v = probs.to(v_cache.dtype), v_cache
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    out = out.reshape(b, kv_heads, group, s, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, n_heads, d)


def paged_decode_attention(q, k_pool, v_pool, tables, cache_len, *,
                           softmax_scale: float | None = None):
    """Decode attention over ONE layer of the paged pool through per-row
    block tables.

    q ``[b, s, n_heads, d]``, pools ``[n_blocks, kv_heads, block, d]`` (or
    int8 ``{"q", "scale"}`` pairs), ``tables`` ``[b, T]`` (entries past a
    row's fill point at the trash block), ``cache_len`` the position of
    q's first token.  Where ``paged_decode_kernel_eligible`` holds, K10 or
    K11 reads the blocks in place; everywhere else the tables are gathered
    into the dense ``[b, kv, T*block, d]`` view (one gather per leaf) and
    ``decode_attention`` runs on it, so both routes share the masking and
    softmax math.  The serving engine keeps the JAX package's dense-gather
    route and does not call this (ROADMAP.md, Queue 2, "Faster paths",
    first bullet)."""
    from ..kernels import flash_decode as fd

    kv_q = is_quantized_cache(k_pool)
    if paged_decode_kernel_eligible(q, k_pool):
        lens = torch.as_tensor(cache_len, device=q.device) + 1
        q1 = q[:, 0].contiguous()
        if kv_q:
            out = fd.flash_decode_paged_int8(
                q1, k_pool["q"], k_pool["scale"], v_pool["q"],
                v_pool["scale"], tables, lens, softmax_scale=softmax_scale)
        else:
            out = fd.flash_decode_paged(q1, k_pool, v_pool, tables, lens,
                                        softmax_scale=softmax_scale)
        return out[:, None]

    def gather(pool):
        if kv_q:
            return {k: fd.gather_blocks(v, tables) for k, v in pool.items()}
        return fd.gather_blocks(pool, tables)

    return decode_attention(q, gather(k_pool), gather(v_pool), cache_len,
                            softmax_scale=softmax_scale)


def dot_product_attention(q, k, v, *, causal: bool = True, bias=None,
                          segment_ids=None, softmax_scale=None,
                          dropout_rate: float = 0.0,
                          dropout_key=None,
                          dropout_slices=()) -> torch.Tensor:
    """Einsum attention, q ``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``, with
    an fp32 softmax.  Attention dropout (JAX ``ops/attention.py:488-490``)
    drops the probabilities, in v's dtype, with the mask of
    ``dropout_key`` over ``[b, kv_heads, group, sq, sk]``; under tensor
    parallelism ``dropout_slices`` places this rank's heads in the global
    mask (``ops/dropout.block_mask``)."""
    b, sq, n_heads, d = q.shape
    _, sk, kv_heads, _ = k.shape
    group = n_heads // kv_heads
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kv_heads, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores * softmax_scale
    if causal:
        scores = scores + make_causal_mask(sq, sk, scores.dtype, q.device)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :sq, None] == segment_ids[:, None, :sk]
        scores = scores.masked_fill(~seg_mask[:, None, None], float("-inf"))
    if bias is not None:
        bias_ = bias
        if bias_.shape[1] == n_heads:
            bias_ = bias_.reshape(b, kv_heads, group, sq, sk)
        else:
            bias_ = bias_[:, :, None]
        scores = scores + bias_
    probs = torch.softmax(scores.float(), dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    probs = probs.to(v.dtype)
    probs = dropout(probs, dropout_rate, dropout_key, dropout_slices)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, n_heads, d)


def attention(q, k, v, *, impl: str = "dot", causal: bool = True,
              segment_ids=None, softmax_scale=None, dropout_rate: float = 0.0,
              dropout_key=None, bias=None, cp_axis: str | None = None,
              cp_zigzag: bool = False, mesh=None,
              dropout_slices=()) -> torch.Tensor:
    """Dispatcher: ``"flash"`` → the flash kernel module, ``"dot"`` → the
    einsum path.

    The flash kernel takes neither a bias nor attention dropout, so a bias
    or a nonzero ``dropout_rate`` routes ``"flash"`` to the einsum path:
    the JAX package's own routing (``ops/attention.py:542``), where the
    reference also applies attention dropout outside its fused kernel.
    Training GPT with ``attention_dropout`` therefore runs einsum
    attention; evaluation and serving (no key, rate 0) keep the kernel.

    ``cp_axis`` (context parallelism, the sequence split over that axis of
    ``mesh`` or the current mesh) takes the ring
    (``parallel/ring_attention.py``; zigzag-ordered shards with
    ``cp_zigzag``), whatever ``impl`` says: its blocks are plain PyTorch,
    as JAX's are (JAX ``ops/attention.py:515-540``).  It takes neither a
    bias nor attention dropout, and raises on either.  Under
    ``ring_attention.whole_sequence`` q, k and v are the whole sequence
    on every cp rank (a custom loss's batch, which the step does not cut).
    """
    if cp_axis is not None:
        if bias is not None or dropout_rate > 0.0:
            raise ValueError(
                "ring attention (context parallelism) does not support "
                "attention bias or attention dropout; set "
                "attention_dropout=0 or disable context_parallel")
        from ..parallel.ring_attention import ring_attention, \
            ring_attention_whole, ring_attention_zigzag, whole_sequence_on

        if whole_sequence_on():
            if cp_zigzag:
                raise ValueError("the zigzag cp layout takes the LM loss's "
                                 "permuted batch; a custom loss runs the "
                                 "contiguous ring")
            return ring_attention_whole(
                q, k, v, mesh=mesh, axis_name=cp_axis, causal=causal,
                segment_ids=segment_ids, softmax_scale=softmax_scale)
        if cp_zigzag:
            if not causal:
                raise ValueError("zigzag cp layout is causal-only")
            return ring_attention_zigzag(
                q, k, v, mesh=mesh, axis_name=cp_axis,
                segment_ids=segment_ids, softmax_scale=softmax_scale)
        return ring_attention(q, k, v, mesh=mesh, axis_name=cp_axis,
                              causal=causal, segment_ids=segment_ids,
                              softmax_scale=softmax_scale)
    if impl == "flash" and bias is None and dropout_rate == 0.0:
        from ..kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               softmax_scale=softmax_scale)
    return dot_product_attention(
        q, k, v, causal=causal, segment_ids=segment_ids,
        softmax_scale=softmax_scale, dropout_rate=dropout_rate,
        dropout_key=dropout_key, bias=bias, dropout_slices=dropout_slices)
