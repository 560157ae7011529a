"""The KV-cache write point and the int8 KV cache (mirror of
``megatron_llm_tpu/ops/kv_quant.py``).

A quantized cache is ``{"q": int8 [..., max_len, d], "scale": fp32
[..., max_len]}``: symmetric, one fp32 scale per (batch, kv head, position)
row of ``d`` values.  K and V rows are written once at their position and
never rewritten, so the scale granularity is the write granularity and no
row is ever requantized.  Decode reads it through the int8 decode kernels
(``kernels/flash_decode.py``, K9 and K11) or the scale-folded einsum of
``ops/attention.py``; a prefill attends over the fresh, unquantized K/V and
only writes here.
"""

from __future__ import annotations

import numpy as np
import torch


def is_quantized_cache(cache) -> bool:
    return isinstance(cache, dict) and set(cache) == {"q", "scale"}


def init_quantized_cache(shape: tuple, device=None) -> dict:
    """Empty cache for ``shape`` = [..., max_len, head_dim]."""
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                 device=device)}


# Scales are amax * (1/127) in fp32, not amax / 127: JAX's fused kernels
# recompute row scales in-kernel and must land on the very same fp32 as
# the host's quantize_rows, and a constant multiply is one exactly rounded
# op everywhere (JAX ops/kv_quant.py:52-62).  The constant is the fp32
# reciprocal, exactly representable as the Python float here.
_RCP127 = float(np.float32(1.0) / np.float32(127.0))


def _row_scale(r32: torch.Tensor, keepdim: bool) -> torch.Tensor:
    scale = r32.abs().amax(dim=-1, keepdim=keepdim) * _RCP127
    return torch.where(scale == 0, torch.ones_like(scale), scale)


def quantize_rows(rows: torch.Tensor) -> dict:
    """[..., s, d] new rows → {"q": int8, "scale": fp32 [..., s]}.  The
    division is a true fp32 division and ``torch.round`` rounds half to
    even, as ``jnp.round`` does: the codes and scales are JAX's, bit for
    bit."""
    r32 = rows.float()
    scale = _row_scale(r32, keepdim=False)
    q = torch.clamp(torch.round(r32 / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def fake_quantize_rows(rows: torch.Tensor) -> torch.Tensor:
    """dequantize(quantize(rows)) in one shot: the values an int8 cache
    holds after ``cache_update`` writes ``rows``, in ``rows``' dtype.
    Requantizing the result is idempotent (the row max is exactly
    scale * 127, so the scale comes back bit for bit and every code rounds
    back to itself), which the fused decode kernel relies on."""
    r32 = rows.float()
    scale = _row_scale(r32, keepdim=True)
    deq = torch.clamp(torch.round(r32 / scale), -127, 127) * scale
    return deq.to(rows.dtype)


def dequantize_cache(cache: dict, dtype=torch.float32) -> torch.Tensor:
    return (cache["q"].float() * cache["scale"][..., None]).to(dtype)


def _write(cache: torch.Tensor, rows: torch.Tensor, pos, seq_axis: int,
           b_axis: int) -> None:
    """``cache[..., pos:pos+s, ...] = rows`` along ``seq_axis``, in place,
    the start clamped to ``[0, max_len - s]`` as
    ``jax.lax.dynamic_update_slice`` clamps it.  A tensor ``pos`` gives
    each sample (axis ``b_axis``) its own start."""
    s = rows.shape[seq_axis]
    max_len = cache.shape[seq_axis]
    if isinstance(pos, int):
        start = min(max(pos, 0), max_len - s)
        cache.narrow(seq_axis, start, s).copy_(rows)
        return
    b = rows.shape[b_axis]
    pos = torch.as_tensor(pos, device=cache.device).to(torch.long)
    starts = torch.clamp(pos.reshape(-1).expand(b), 0, max_len - s)
    idx = starts[:, None] + torch.arange(s, device=cache.device)  # [b, s]
    bi = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    # views with (batch, position) leading, so one index_put writes every
    # sample's rows at its own position
    dst = cache.movedim(b_axis, 0).movedim(seq_axis, 1)
    dst[bi, idx] = rows.movedim(b_axis, 0).movedim(seq_axis, 1)


def cache_update(cache, rows: torch.Tensor, pos):
    """Write new-token ``rows`` [..., s, d] into ``cache`` [..., max_len, d]
    at position ``pos`` along the sequence axis (-2), IN PLACE, and
    return the cache.  An int8 ``{"q", "scale"}`` cache gets the rows
    through ``quantize_rows``, both leaves written.

    ``pos`` is a Python int, or a 0-d / [batch] tensor of fill levels
    with batch at axis ``ndim - 4`` (dims ``[..., b, kv, max_len, d]``).
    As with ``jax.lax.dynamic_update_slice`` a start that would run past
    the end is clamped to ``max_len - s``.  The JAX function returns a
    new array; the port writes in place to avoid a full cache copy per
    step, and a tensor ``pos`` never leaves the device."""
    b_axis = rows.ndim - 4
    if is_quantized_cache(cache):
        if cache["q"].dtype != torch.int8 \
                or cache["scale"].dtype != torch.float32:
            raise TypeError(f"an int8 KV cache holds int8 codes and fp32 "
                            f"scales, got {cache['q'].dtype} and "
                            f"{cache['scale'].dtype}")
        qr = quantize_rows(rows)
        _write(cache["q"], qr["q"], pos, rows.ndim - 2, b_axis)
        _write(cache["scale"], qr["scale"], pos, rows.ndim - 2, b_axis)
        return cache
    _write(cache, rows.to(cache.dtype), pos, rows.ndim - 2, b_axis)
    return cache
