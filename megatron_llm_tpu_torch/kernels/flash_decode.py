"""Decode attention for one new token over a dense KV cache: the CUDA
kernel ``csrc/flash_decode.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``megatron_llm_tpu/kernels/flash_decode.py``
(``_decode_kernel`` via ``flash_decode``).  Layout as in JAX: q
``[b, n_heads, d]``, caches ``[b, kv_heads, max_len, d]``, ``cache_len`` =
valid rows per batch row INCLUDING the new token (a scalar or ``[b]``).
Returns ``[b, n_heads, d]`` in q's dtype.  What bounds the kernel on the
H100 and how it is laid out is written at the top of the CUDA source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The int8 and paged variants are later slices.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
NEG_INF = -1e30  # the TPU kernel's finite mask value


def _lens(cache_len, b: int, device) -> torch.Tensor:
    """Fill levels as a [b] int32 tensor on ``device``."""
    lens = torch.as_tensor(cache_len, device=device).to(torch.int32)
    return lens.reshape(-1).expand(b).contiguous()


def flash_decode_plain(q, k_cache, v_cache, cache_len, *,
                       softmax_scale=None):
    """The kernel's function in plain torch (fp32 math).  Columns at or past
    a row's fill get the TPU kernel's finite ``NEG_INF`` score, so they
    carry exactly zero weight whenever the fill is positive, and a row with
    fill 0 averages its whole cache, as the TPU kernel's does."""
    b, n_heads, d = q.shape
    _, kv_heads, max_len, _ = k_cache.shape
    group = n_heads // kv_heads
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kv_heads, group, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * softmax_scale
    lens = _lens(cache_len, b, q.device)
    keep = torch.arange(max_len, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, n_heads, d).to(q.dtype)


def kernel_takes(q, k_cache) -> bool:
    """Whether the CUDA kernel takes these operands (the decode-path
    eligibility predicate of ops/attention.py builds on it)."""
    if not (q.is_cuda and k_cache.is_cuda):
        return False
    n_heads, d = q.shape[-2], q.shape[-1]
    kv_heads = k_cache.shape[-3]
    return (q.dtype == k_cache.dtype and q.dtype in _DTYPE_CODES
            and d in _HEAD_DIMS and n_heads % kv_heads == 0
            and n_heads // kv_heads <= _MAX_GROUP)


def _check(q, k_cache, v_cache):
    if not (q.is_cuda and k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("flash_decode: q and caches must be CUDA tensors")
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2]:
        raise ValueError(f"flash_decode: bad shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    if not kernel_takes(q, k_cache) or v_cache.dtype != q.dtype:
        raise ValueError(
            f"flash_decode: the kernel takes fp32/bf16/fp16, head dim in "
            f"{_HEAD_DIMS} and a GQA group <= {_MAX_GROUP}; got {q.dtype}, "
            f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode: q and caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and caches must be 16-byte aligned "
                         "(the kernel loads 16 bytes per thread)")


def flash_decode(q, k_cache, v_cache, cache_len, *, softmax_scale=None):
    """→ [b, n_heads, d]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len,
                                  softmax_scale=softmax_scale)
    _check(q, k_cache, v_cache)
    b, n_heads, d = q.shape
    _, kv_heads, max_len, _ = k_cache.shape
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    lens = _lens(cache_len, b, q.device)
    out = torch.empty_like(q)
    err = _lib().flash_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, n_heads, kv_heads, max_len, d,
        float(softmax_scale), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _lib():
    lib = build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
    return lib
