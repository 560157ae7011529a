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
``[b, n_heads, d]`` in q's dtype.

The kernels split each row's cache walk into fixed chunks of
``SPLIT_COLS`` columns (``decode_splits`` mirrors the CUDA source's plan),
one block a (row, kv head, split); inside a split one thread stages 64-row
tiles of K and V into shared memory with bulk copies; a row with several
live splits writes fp32 partials to scratch (``torch.empty``, per call)
and the last split of the row to arrive, found by a ticket in a zeroed
int32 buffer kept per device (``_tickets``), merges them in split order.
So a row's bits depend only on its own q, cache and fill: a row alone
equals its row in any batch, run to run, and the paged kernels give the
dense kernels' output bit for bit on the same logical cache.  What bounds
the kernels on the H100 and the rest of the design is written at the top
of the CUDA source; ``flash_decode_split_plain`` is the split-then-merge in
plain fp32 torch, in the kernels' split order.  The launcher reports the
body it ran: each wrapper counts it in ``split_launches``.  A ticket
buffer is shared by the calls on one device, so concurrent calls on two
streams of one device are not supported.

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
# kSplitCols of csrc/flash_decode.cu: the columns a block of K8-K11 walks,
# for every head dim and cache type (a multiple of the pool blocks 16, 64
# and 128)
SPLIT_COLS = 256
_BODY_SPLIT = 3   # kBodySplit of csrc/common.cuh
# the splits a row's merge stages in shared memory (kMaxSplits of
# csrc/flash_decode.cu is at least this for every instantiation)
_MAX_SPLITS = 512


def decode_splits(fill: int, width: int) -> list:
    """The kernels' split plan of one row: ``[(start, end), ...]``
    covering ``[0, fill)`` in order, every boundary a multiple of
    ``SPLIT_COLS``.  Fill 0 (and a fill past the width) covers the width,
    as the kernels' walk does."""
    n = width if fill <= 0 or fill > width else fill
    return [(s, min(s + SPLIT_COLS, n)) for s in range(0, n, SPLIT_COLS)]


def n_splits(width: int) -> int:
    """Splits a row of ``width`` columns can have: the grid's third
    factor, and the scratch's."""
    return -(-width // SPLIT_COLS)


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


def flash_decode_split_plain(q, k_cache, v_cache, cache_len, *,
                             k_scale=None, v_scale=None, tables=None,
                             softmax_scale=None):
    """K8-K11's split-then-merge in plain fp32 torch, in the kernels'
    split order: each split of ``decode_splits`` gives (m, l, acc) over its
    columns (the int8 scales folded as ``_attend_plain`` folds them), then
    the splits merge in order: m = max m_s, w_s = exp(m_s - m), l = sum l_s
    w_s, o = sum acc_s w_s, out = o / l.  An int8 cache passes its scales;
    a pool passes ``tables`` (read through ``gather_blocks``).  Row by row,
    so a row's bits do not depend on the batch."""
    if tables is not None:
        k_cache, v_cache = (gather_blocks(c, tables)
                            for c in (k_cache, v_cache))
        if k_scale is not None:
            k_scale, v_scale = (gather_blocks(c, tables)
                                for c in (k_scale, v_scale))
    b, n_heads, d = q.shape
    _, kv_heads, width, _ = k_cache.shape
    g = n_heads // kv_heads
    scale = _scale(softmax_scale, d)
    fills = _lens(cache_len, b, q.device).tolist()
    outs = []
    for bi in range(b):
        qg = q[bi].float().reshape(kv_heads, g, d)
        parts = []
        for s0, s1 in decode_splits(fills[bi], width):
            s = torch.einsum("hgd,hkd->hgk", qg,
                             k_cache[bi, :, s0:s1].float())
            if k_scale is not None:
                s = s * k_scale[bi, :, None, s0:s1].float()
            s = s * scale
            if fills[bi] <= 0:
                s = torch.zeros_like(s)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            lsum = p.sum(-1, keepdim=True)
            if v_scale is not None:
                p = p * v_scale[bi, :, None, s0:s1].float()
            parts.append((m, lsum, torch.einsum(
                "hgk,hkd->hgd", p, v_cache[bi, :, s0:s1].float())))
        mt = torch.stack([m for m, _, _ in parts]).amax(0)
        lt = torch.zeros_like(mt)
        o = torch.zeros_like(parts[0][2])
        for m, lsum, acc in parts:
            w = torch.exp(m - mt)
            lt = lt + lsum * w
            o = o + acc * w
        outs.append((o / lt).reshape(n_heads, d))
    return torch.stack(outs).to(q.dtype)


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
                         "(the kernel copies them in 16-byte units)")


def _check_scales(name, cache, k_scale, v_scale):
    for s in (k_scale, v_scale):
        if not (s.is_cuda and s.dtype == torch.float32 and s.is_contiguous()
                and tuple(s.shape) == tuple(cache.shape[:-1])
                and s.data_ptr() % 16 == 0):
            raise ValueError(f"{name}: scales must be contiguous 16-byte "
                             f"aligned fp32 CUDA tensors of shape "
                             f"{tuple(cache.shape[:-1])}, got {s.dtype} "
                             f"{tuple(s.shape)}")


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


_TICKETS: dict = {}


def _tickets(device, n: int) -> torch.Tensor:
    """The device's int32 ticket buffer (zeros between launches: each
    merging block resets its own), at least ``n`` long."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _launch(fn, inputs, shape_args, q, kv_heads: int, width: int,
            softmax_scale):
    """``fn``'s C entry on ``inputs`` (pointers before ``out``) and
    ``shape_args`` (ints after kv_heads): the output, the split partials'
    scratch and the tickets where a row can have several splits; counts
    the launch and the body the launcher reports."""
    b, n_heads, d = q.shape
    ns = n_splits(width)
    if ns > _MAX_SPLITS:
        raise ValueError(f"{fn.__name__}: a cache of {width} columns has "
                         f"{ns} splits; the kernel merges up to "
                         f"{_MAX_SPLITS} ({_MAX_SPLITS * SPLIT_COLS} columns)")
    out = torch.empty_like(q)
    part, tickets, n_part = None, None, 0
    if ns > 1:
        # the tickets first (their first allocation on a device), then the
        # scratch, held until the launch is queued: the allocator hands a
        # freed block out again at once
        tickets = _tickets(q.device, b * kv_heads)
        n_part = b * n_heads * ns * (d + 2)
        part = torch.empty(n_part, dtype=torch.float32, device=q.device)
    body = ctypes.c_int(-1)
    err = _entry(fn.__name__ + "_launch")(
        *(t.data_ptr() for t in inputs), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part, tickets)), b,
        n_heads, kv_heads, *shape_args, d, float(_scale(softmax_scale, d)),
        _DTYPE_CODES[q.dtype], n_part, _stream(q), ctypes.byref(body))
    build.check(err, fn.__name__)
    fn.launches += 1
    fn.split_launches += body.value == _BODY_SPLIT
    return out


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
    _, kv_heads, max_len, _ = k_cache.shape
    lens = _lens(cache_len, q.shape[0], q.device)
    return _launch(flash_decode, (q, k_cache, v_cache, lens), (max_len,),
                   q, kv_heads, max_len, softmax_scale)


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
    _, kv_heads, max_len, _ = k_q.shape
    lens = _lens(cache_len, q.shape[0], q.device)
    return _launch(flash_decode_int8, (q, k_q, k_scale, v_q, v_scale, lens),
                   (max_len,), q, kv_heads, max_len, softmax_scale)


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
    kv_heads, block = k_pool.shape[1], k_pool.shape[2]
    lens = _lens(cache_len, q.shape[0], q.device)
    tbl = _tables32(tables, q.device)
    return _launch(flash_decode_paged, (q, k_pool, v_pool, lens, tbl),
                   (block, tbl.shape[1]), q, kv_heads, block * tbl.shape[1],
                   softmax_scale)


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
    kv_heads, block = k_q.shape[1], k_q.shape[2]
    lens = _lens(cache_len, q.shape[0], q.device)
    tbl = _tables32(tables, q.device)
    return _launch(flash_decode_paged_int8,
                   (q, k_q, k_scale, v_q, v_scale, lens, tbl),
                   (block, tbl.shape[1]), q, kv_heads, block * tbl.shape[1],
                   softmax_scale)


for _fn in (flash_decode, flash_decode_int8, flash_decode_paged,
            flash_decode_paged_int8):
    _fn.launches = 0
    _fn.split_launches = 0  # launches the launcher reports on the split body
del _fn

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# argument types of each C entry point (csrc/flash_decode.cu): inputs, out,
# part, tickets; b, n_heads, kv_heads, shape ints, d; scale; dtype; n_part;
# stream; body
_ARGTYPES = {
    name: [_P] * (n_in + 3) + [_I] * (n_shape + 4) + [_F, _I, _L, _P, _P]
    for name, n_in, n_shape in (("flash_decode_launch", 4, 1),
                                ("flash_decode_int8_launch", 6, 1),
                                ("flash_decode_paged_launch", 5, 2),
                                ("flash_decode_paged_int8_launch", 7, 2))}


def _entry(name: str):
    """The C entry point ``name`` of the built library, typed."""
    fn = getattr(build.load("flash_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn
