"""Decode attention for one new token: the CUDA kernels of
``csrc/flash_decode.cu`` (K8-K11) and their plain PyTorch versions.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/flash_decode.py``:

- ``flash_decode`` (K8): a dense cache ``[b, kv_heads, max_len, d]`` in q's
  dtype;
- ``flash_decode_int8`` (K9): an int8 cache with fp32 per-row scales
  ``[b, kv_heads, max_len]`` (the ``ops/kv_quant.py`` form), folded into
  the scores and the probabilities;
- ``flash_decode_paged`` (K10) and ``flash_decode_paged_int8`` (K11): the
  same, read from one layer of the block pool ``[n_blocks, kv_heads, block,
  d]`` through int32 block tables ``[b, T]``: logical row j of batch row b
  is ``pool[table[b, j // block], :, j % block]``.

Layout as in JAX: q ``[b, n_heads, d]``, ``cache_len`` = valid rows per
batch row INCLUDING the new token (a scalar or ``[b]``).  Each returns
``[b, n_heads, d]`` in q's dtype.  What bounds the kernels on the H100 and
how they are laid out is written at the top of the CUDA source.  The paged
kernels give the dense kernels' output bit for bit on the same logical
cache.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
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


def _scale(softmax_scale, d: int) -> float:
    return 1.0 / math.sqrt(d) if softmax_scale is None else softmax_scale


def gather_blocks(pool: torch.Tensor, tables) -> torch.Tensor:
    """One layer's pool leaf ``[n_blocks, kv, block(, d)]`` read through
    tables ``[b, T]`` → the dense view ``[b, kv, T*block(, d)]``."""
    b, t = tables.shape
    x = pool[torch.as_tensor(tables, device=pool.device).to(torch.long)]
    x = x.transpose(1, 2)                    # [b, kv, T, block(, d)]
    return x.reshape((b, pool.shape[1], t * pool.shape[2])
                     + tuple(pool.shape[3:]))


def _attend_plain(q, k32, v32, cache_len, softmax_scale, k_scale=None,
                  v_scale=None):
    """fp32 decode attention over fp32 views of the cache, with the int8
    form's scales folded in as the TPU kernel folds them: score = (q . k) *
    k_scale * softmax_scale; each probability times its v_scale."""
    b, n_heads, d = q.shape
    _, kv_heads, max_len, _ = k32.shape
    group = n_heads // kv_heads
    qg = q.float().reshape(b, kv_heads, group, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k32)
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    s = s * _scale(softmax_scale, d)
    lens = _lens(cache_len, b, q.device)
    keep = torch.arange(max_len, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    o = torch.einsum("bhgk,bhkd->bhgd", p, v32)
    return o.reshape(b, n_heads, d).to(q.dtype)


def flash_decode_plain(q, k_cache, v_cache, cache_len, *,
                       softmax_scale=None):
    """K8's function in plain torch (fp32 math).  Columns at or past a
    row's fill get the TPU kernel's finite ``NEG_INF`` score, so they carry
    exactly zero weight whenever the fill is positive, and a row with fill
    0 averages its whole cache, as the TPU kernel's does."""
    return _attend_plain(q, k_cache.float(), v_cache.float(), cache_len,
                         softmax_scale)


def flash_decode_int8_plain(q, k_q, k_scale, v_q, v_scale, cache_len, *,
                            softmax_scale=None):
    """K9's function in plain torch: int8 K/V widened to fp32, the fp32 row
    scales folded into the scores and the probabilities."""
    return _attend_plain(q, k_q.float(), v_q.float(), cache_len,
                         softmax_scale, k_scale.float(), v_scale.float())


def flash_decode_paged_plain(q, k_pool, v_pool, tables, cache_len, *,
                             softmax_scale=None):
    """K10's function: K8's over the tables' dense view."""
    return flash_decode_plain(q, gather_blocks(k_pool, tables),
                              gather_blocks(v_pool, tables), cache_len,
                              softmax_scale=softmax_scale)


def flash_decode_paged_int8_plain(q, k_q, k_scale, v_q, v_scale, tables,
                                  cache_len, *, softmax_scale=None):
    """K11's function: K9's over the tables' dense view."""
    g = gather_blocks
    return flash_decode_int8_plain(
        q, g(k_q, tables), g(k_scale, tables), g(v_q, tables),
        g(v_scale, tables), cache_len, softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# What the kernels take
# ---------------------------------------------------------------------------


def _shape_takes(q, kv_heads: int) -> bool:
    n_heads, d = q.shape[-2], q.shape[-1]
    return (q.dtype in _DTYPE_CODES and d in _HEAD_DIMS
            and n_heads % kv_heads == 0 and n_heads // kv_heads <= _MAX_GROUP)


def kernel_takes(q, k_cache) -> bool:
    """Whether K8 takes these operands (the decode-path eligibility
    predicate of ops/attention.py builds on it)."""
    return (q.is_cuda and k_cache.is_cuda and q.dtype == k_cache.dtype
            and _shape_takes(q, k_cache.shape[-3]))


def int8_kernel_takes(q, k_q) -> bool:
    """Whether K9 takes q over the int8 cache leaf ``k_q``.  Falcon-7B's
    group of 71 is above the cap, as for K8: it decodes on the einsum
    path."""
    return (q.is_cuda and k_q.is_cuda and k_q.dtype == torch.int8
            and _shape_takes(q, k_q.shape[-3]))


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def paged_kernel_takes(q, k_pool) -> bool:
    """Whether K10 (a pool in q's dtype) or K11 (an int8 pool leaf) takes
    these operands: K8's / K9's rule, and a power-of-two block (the
    engine's 64 and 128 among them)."""
    dense_ok = kernel_takes if k_pool.dtype != torch.int8 \
        else int8_kernel_takes
    return dense_ok(q, k_pool) and _is_pow2(k_pool.shape[-2])


def _check_common(name, q, caches, takes):
    if not (q.is_cuda and all(c.is_cuda for c in caches)):
        raise ValueError(f"{name}: q and caches must be CUDA tensors")
    if not takes:
        raise ValueError(
            f"{name}: the kernel takes fp32/bf16/fp16 q, head dim in "
            f"{_HEAD_DIMS}, a GQA group <= {_MAX_GROUP} and a cache in q's "
            f"dtype (int8 for the int8 kernels); got q {q.dtype} "
            f"{tuple(q.shape)}, cache {caches[0].dtype} "
            f"{tuple(caches[0].shape)}")
    if not (q.is_contiguous() and all(c.is_contiguous() for c in caches)):
        raise ValueError(f"{name}: q and caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, *caches)):
        raise ValueError(f"{name}: q and caches must be 16-byte aligned "
                         "(the kernel loads 16 bytes per thread)")


def _check_scales(name, cache, k_scale, v_scale):
    for s in (k_scale, v_scale):
        if not (s.is_cuda and s.dtype == torch.float32 and s.is_contiguous()
                and tuple(s.shape) == tuple(cache.shape[:-1])):
            raise ValueError(f"{name}: scales must be contiguous fp32 CUDA "
                             f"tensors of shape {tuple(cache.shape[:-1])}, "
                             f"got {s.dtype} {tuple(s.shape)}")


def _check_dense(name, q, k, v):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(k.shape)}")


def _check_paged(name, q, k, v, tables):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[3] != q.shape[2]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} pool "
                         f"{tuple(k.shape)}")
    if tables.ndim != 2 or tables.shape[0] != q.shape[0] \
            or tables.shape[1] < 1 or tables.dtype.is_floating_point:
        raise ValueError(f"{name}: tables must be integer [b, T], got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if not _is_pow2(k.shape[2]):
        raise ValueError(f"{name}: the block size must be a power of two, "
                         f"got {k.shape[2]}")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _tables32(tables, device):
    return torch.as_tensor(tables, device=device).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def flash_decode(q, k_cache, v_cache, cache_len, *, softmax_scale=None):
    """K8 → [b, n_heads, d]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cache_len,
                                  softmax_scale=softmax_scale)
    _check_common("flash_decode", q, (k_cache, v_cache),
                  kernel_takes(q, k_cache) and v_cache.dtype == q.dtype)
    _check_dense("flash_decode", q, k_cache, v_cache)
    b, n_heads, d = q.shape
    _, kv_heads, max_len, _ = k_cache.shape
    lens = _lens(cache_len, b, q.device)
    out = torch.empty_like(q)
    err = _entry("flash_decode_launch")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, n_heads, kv_heads, max_len, d,
        float(_scale(softmax_scale, d)), _DTYPE_CODES[q.dtype], _stream(q))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


def flash_decode_int8(q, k_q, k_scale, v_q, v_scale, cache_len, *,
                      softmax_scale=None):
    """K9 → [b, n_heads, d] over an int8 cache: ``k_q``/``v_q`` int8
    ``[b, kv, max_len, d]``, ``k_scale``/``v_scale`` fp32 ``[b, kv,
    max_len]``."""
    if q.device.type == "cpu":
        return flash_decode_int8_plain(q, k_q, k_scale, v_q, v_scale,
                                       cache_len, softmax_scale=softmax_scale)
    name = "flash_decode_int8"
    _check_common(name, q, (k_q, v_q),
                  int8_kernel_takes(q, k_q) and v_q.dtype == torch.int8)
    _check_dense(name, q, k_q, v_q)
    _check_scales(name, k_q, k_scale, v_scale)
    b, n_heads, d = q.shape
    _, kv_heads, max_len, _ = k_q.shape
    lens = _lens(cache_len, b, q.device)
    out = torch.empty_like(q)
    err = _entry("flash_decode_int8_launch")(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(), b, n_heads,
        kv_heads, max_len, d, float(_scale(softmax_scale, d)),
        _DTYPE_CODES[q.dtype], _stream(q))
    build.check(err, name)
    flash_decode_int8.launches += 1
    return out


def flash_decode_paged(q, k_pool, v_pool, tables, cache_len, *,
                       softmax_scale=None):
    """K10 → [b, n_heads, d] read from one layer's pool ``[n_blocks, kv,
    block, d]`` (q's dtype) through ``tables`` ``[b, T]``.  Entries past a
    row's fill (the trash block) are never read."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, tables, cache_len,
                                        softmax_scale=softmax_scale)
    name = "flash_decode_paged"
    _check_common(name, q, (k_pool, v_pool),
                  kernel_takes(q, k_pool) and v_pool.dtype == q.dtype)
    _check_paged(name, q, k_pool, v_pool, tables)
    b, n_heads, d = q.shape
    kv_heads, block = k_pool.shape[1], k_pool.shape[2]
    lens = _lens(cache_len, b, q.device)
    tbl = _tables32(tables, q.device)
    out = torch.empty_like(q)
    err = _entry("flash_decode_paged_launch")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), lens.data_ptr(),
        tbl.data_ptr(), out.data_ptr(), b, n_heads, kv_heads, block,
        tbl.shape[1], d, float(_scale(softmax_scale, d)),
        _DTYPE_CODES[q.dtype], _stream(q))
    build.check(err, name)
    flash_decode_paged.launches += 1
    return out


def flash_decode_paged_int8(q, k_q, k_scale, v_q, v_scale, tables,
                            cache_len, *, softmax_scale=None):
    """K11 → [b, n_heads, d] over the int8 pool form: ``k_q``/``v_q`` int8
    ``[n_blocks, kv, block, d]``, ``k_scale``/``v_scale`` fp32 ``[n_blocks,
    kv, block]``, through ``tables`` ``[b, T]``."""
    if q.device.type == "cpu":
        return flash_decode_paged_int8_plain(
            q, k_q, k_scale, v_q, v_scale, tables, cache_len,
            softmax_scale=softmax_scale)
    name = "flash_decode_paged_int8"
    _check_common(name, q, (k_q, v_q),
                  int8_kernel_takes(q, k_q) and v_q.dtype == torch.int8)
    _check_paged(name, q, k_q, v_q, tables)
    _check_scales(name, k_q, k_scale, v_scale)
    b, n_heads, d = q.shape
    kv_heads, block = k_q.shape[1], k_q.shape[2]
    lens = _lens(cache_len, b, q.device)
    tbl = _tables32(tables, q.device)
    out = torch.empty_like(q)
    err = _entry("flash_decode_paged_int8_launch")(
        q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
        v_scale.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        b, n_heads, kv_heads, block, tbl.shape[1], d,
        float(_scale(softmax_scale, d)), _DTYPE_CODES[q.dtype], _stream(q))
    build.check(err, name)
    flash_decode_paged_int8.launches += 1
    return out


for _fn in (flash_decode, flash_decode_int8, flash_decode_paged,
            flash_decode_paged_int8):
    _fn.launches = 0
del _fn

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each C entry point (csrc/flash_decode.cu)
_ARGTYPES = {
    "flash_decode_launch": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "flash_decode_int8_launch": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "flash_decode_paged_launch": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "flash_decode_paged_int8_launch": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
}


def _entry(name: str):
    """The C entry point ``name`` of the built library, typed."""
    fn = getattr(build.load("flash_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn
