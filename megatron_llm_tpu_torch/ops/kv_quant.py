"""The KV-cache write point (mirror of ``megatron_llm_tpu/ops/kv_quant.py``
for the plain floating-point cache).

The int8 ``{"q", "scale"}`` cache form is recognised so that it fails
loudly: quantizing rows and the int8 decode kernel are a later slice.
"""

from __future__ import annotations

import torch

_INT8_TODO = ("the int8 KV cache is not ported yet (ROADMAP.md, Queue 1: "
              "int8 KV cache; Queue 2: flash_decode_int8)")


def is_quantized_cache(cache) -> bool:
    return isinstance(cache, dict) and set(cache) == {"q", "scale"}


def cache_update(cache: torch.Tensor, rows: torch.Tensor, pos):
    """Write new-token ``rows`` [..., s, d] into ``cache`` [..., max_len, d]
    at position ``pos`` along the sequence axis (-2), IN PLACE, and
    return the cache.

    ``pos`` is a Python int, or a 0-d / [batch] tensor of fill levels
    with batch at axis ``ndim - 4`` (dims ``[..., b, kv, max_len, d]``).
    As with ``jax.lax.dynamic_update_slice`` a start that would run past
    the end is clamped to ``max_len - s``.  The JAX function returns a
    new array; the port writes in place to avoid a full cache copy per
    step, and a tensor ``pos`` never leaves the device."""
    if is_quantized_cache(cache):
        raise NotImplementedError(_INT8_TODO)
    s = rows.shape[-2]
    max_len = cache.shape[-2]
    rows = rows.to(cache.dtype)
    if isinstance(pos, int):
        start = min(max(pos, 0), max_len - s)
        cache[..., start:start + s, :] = rows
        return cache
    b_axis = rows.ndim - 4
    b = rows.shape[b_axis]
    pos = torch.as_tensor(pos, device=cache.device).to(torch.long)
    starts = torch.clamp(pos.reshape(-1).expand(b), 0, max_len - s)
    idx = starts[:, None] + torch.arange(s, device=cache.device)  # [b, s]
    bi = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    # views with (batch, position) leading, so one index_put writes every
    # sample's rows at its own position
    dst = cache.movedim(b_axis, 0).movedim(-2, 1)
    dst[bi, idx] = rows.movedim(b_axis, 0).movedim(-2, 1)
    return cache
