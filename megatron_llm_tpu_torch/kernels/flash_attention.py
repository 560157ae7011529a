"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` (O and lse) and ``csrc/flash_attention_bwd.cu``
(dQ; dK and dV), each beside its plain PyTorch version, and the autograd
Function that joins them.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/flash_attention.py``:
``_fwd_kernel`` (via ``_fwd``), ``_dq_kernel`` and ``_dkv_kernel`` (via
``_bwd_impl``), joined there by ``jax.custom_vjp``.  Layout as in JAX: q
``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``; O ``[b, sq, hq, d]`` in q's
dtype and the fp32 logsumexp ``[b, hq, sq]``.  The backward kernels take
the forward's layout and its lse; ``delta = rowsum(dO * O)`` is computed in
fp32 outside them, as the JAX wrapper does.  What bounds each kernel on the
H100 and how it is laid out is written at the top of its CUDA source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises on a dtype, head size or layout the kernel does not take.  Each
wrapper counts its launches in ``launches``, those of the tensor-core body
in ``mma_launches`` and those with ``causal=False`` (the encoders) in
``noncausal_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

NO_KEY_LSE = -1e30  # lse of a row that sees no key (its O is 0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BODY_MMA = 1   # the launchers' report: the tensor-core body
_HEAD_DIMS = (64, 128)


def _keep_mask(sq: int, sk: int, causal: bool, segment_ids, device):
    """[b or 1, sq, sk] boolean: which key columns each query row sees."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    keep = (j <= i + (sk - sq)) if causal else torch.ones(
        sq, sk, dtype=torch.bool, device=device)
    keep = keep[None]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, :sq, None] == segment_ids[:, None, :sk])
    return keep


def _acc_dtype(x):
    """fp32 math, or fp64 for fp64 inputs (the gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _rounded(x, like):
    """``x`` rounded to ``like``'s dtype and kept in ``x``'s: where the JAX
    kernels cast a product's operand to the input dtype (the identity for
    fp32 and fp64 inputs)."""
    return x.to(like.dtype).to(x.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          segment_ids=None, softmax_scale=None):
    """The kernel's function in plain torch: ``(O, lse)`` with fp32 math.
    P is rounded to v's dtype before P·V and l is the fp32 sum of the
    unrounded P, as in JAX ``_fwd_kernel``."""
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    group = hq // hk
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(b, sq, hk, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(acc)) * softmax_scale
    keep = _keep_mask(sq, sk, causal, segment_ids, q.device)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", _rounded(p, v), v.to(acc))
    l_q = l.permute(0, 3, 1, 2, 4)  # [b, sq, hk, g, 1]
    o = torch.where(l_q > 0, o / torch.where(l_q > 0, l_q, 1.0), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      NO_KEY_LSE)
    return (o.reshape(b, sq, hq, d).to(q.dtype),
            lse.reshape(b, hq, sq))


def _check(q, k, v, segment_ids):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all be CUDA tensors")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtypes "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if q.shape[2] % k.shape[2]:
        raise ValueError("flash_attention: q heads must be a multiple of "
                         "kv heads")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned "
                         "(the kernel loads 16 bytes per thread)")
    if segment_ids is not None:
        if q.shape[1] != k.shape[1]:
            raise ValueError("flash_attention: segment_ids need sq == sk")
        if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous() \
                or tuple(segment_ids.shape) != (q.shape[0], q.shape[1]) \
                or segment_ids.device != q.device:
            raise ValueError("flash_attention: segment_ids must be a "
                             "contiguous int32 [b, s] tensor on q's device")


def flash_attention_fwd(q, k, v, *, causal: bool = True, segment_ids=None,
                        softmax_scale=None):
    """``(O, lse)``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     segment_ids=segment_ids,
                                     softmax_scale=softmax_scale)
    if segment_ids is not None:  # the JAX wrapper casts to int32 likewise
        segment_ids = segment_ids.to(torch.int32).contiguous()
    _check(q, k, v, segment_ids)
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    seg_ptr = segment_ids.data_ptr() if segment_ids is not None else None
    body = ctypes.c_int(-1)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
        lse.data_ptr(), b, sq, sk, hq, hk, d, float(softmax_scale),
        int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(body))
    build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.mma_launches += body.value == _BODY_MMA
    flash_attention_fwd.noncausal_launches += not causal
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.mma_launches = 0
flash_attention_fwd.noncausal_launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def _bwd_plain_parts(q, k, v, o, lse, do, causal, segment_ids,
                     softmax_scale):
    """What both plain backward halves recompute: P from ``lse`` (a pair
    the mask drops has P = 0 exactly) and dS, in fp32 math, plus the
    upcast operands."""
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    group = hq // hk
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    qf = q.to(acc).reshape(b, sq, hk, group, d)
    dof = do.to(acc).reshape(b, sq, hk, group, d)
    kf, vf = k.to(acc), v.to(acc)
    delta = (dof * o.to(acc).reshape(b, sq, hk, group, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # [b, hk, g, sq, 1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * softmax_scale
    keep = _keep_mask(sq, sk, causal, segment_ids, q.device)[:, None, None]
    lse = lse.to(acc).reshape(b, hk, group, sq, 1)
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta) * softmax_scale
    return qf, kf, dof, p, ds


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool = True,
                                 segment_ids=None, softmax_scale=None):
    """K2's function in plain torch: dQ in q's dtype, with dS rounded to
    k's dtype before dS·K (JAX ``_dq_kernel``)."""
    _, kf, _, _, ds = _bwd_plain_parts(q, k, v, o, lse, do, causal,
                                       segment_ids, softmax_scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", _rounded(ds, k),
                      kf).reshape(q.shape)
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, *, causal: bool = True,
                                  segment_ids=None, softmax_scale=None):
    """K3's function in plain torch: ``(dK, dV)`` in k's and v's dtypes,
    summed over each kv head's q-head group; P rounded to dO's dtype
    before Pᵀ·dO and dS to q's before dSᵀ·Q (JAX ``_dkv_kernel``)."""
    qf, _, dof, p, ds = _bwd_plain_parts(q, k, v, o, lse, do, causal,
                                         segment_ids, softmax_scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", _rounded(ds, q), qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", _rounded(p, do), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              segment_ids=None, softmax_scale=None):
    """The backward kernels' function in plain torch: ``(dQ, dK, dV)`` in
    the inputs' dtypes, from the two halves above."""
    kw = dict(causal=causal, segment_ids=segment_ids,
              softmax_scale=softmax_scale)
    return (flash_attention_bwd_dq_plain(q, k, v, o, lse, do, **kw),
            *flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, **kw))


def _check_bwd(q, k, v, do, lse, delta, segment_ids):
    _check(q, k, v, segment_ids)
    if do.shape != q.shape or do.dtype != q.dtype \
            or not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("flash_attention backward: dO must match q in "
                         "shape and dtype, contiguous and 16-byte aligned")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != rows \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous fp32 {list(rows)} tensor on q's "
                             "device")


def _bwd_args(q, k, segment_ids, softmax_scale):
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    seg_ptr = segment_ids.data_ptr() if segment_ids is not None else None
    return (seg_ptr, b, sq, sk, hq, hk, d, float(softmax_scale))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           segment_ids=None, softmax_scale=None):
    """dQ from the CUDA kernel K2 (CUDA tensors only; ``delta`` fp32
    ``[b, hq, sq]``, ``segment_ids`` contiguous int32 or None).  The C
    launcher sends bf16 / fp16 to the tensor-core body and fp32 to the
    CUDA-core body, and reports the body it ran: a tensor-core launch is
    counted in ``mma_launches`` too."""
    _check_bwd(q, k, v, do, lse, delta, segment_ids)
    seg_ptr, *dims = _bwd_args(q, k, segment_ids, softmax_scale)
    dq = torch.empty_like(q)
    body = ctypes.c_int(-1)
    err = _bwd_lib().flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_ptr, dq.data_ptr(), *dims,
        int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(body))
    build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.mma_launches += body.value == _BODY_MMA
    flash_attention_bwd_dq.noncausal_launches += not causal
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.mma_launches = 0
flash_attention_bwd_dq.noncausal_launches = 0


_DKV_TILE = 64         # keys per K3 block
_DKV_MAX_SPLITS = 16


def _dkv_splits(b: int, hk: int, sk: int, group: int, sm_count: int) -> int:
    """Blocks over which K3's tensor-core body splits each (batch, kv
    head, key tile)'s walk over the q-head group and the q tiles.  A grid
    of at least twice the SM count (two blocks fit on an SM) is not split;
    a smaller one is split towards four blocks a SM, so that the heavy
    (early) key tiles' splits spread over the card, but never into more
    splits than the group has heads (each split keeps whole q tiles of at
    least one head) or 16."""
    blocks = b * hk * -(-sk // _DKV_TILE)
    if blocks >= 2 * sm_count:
        return 1
    return max(1, min(group, _DKV_MAX_SPLITS, -(-4 * sm_count // blocks)))


_SM_COUNTS: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            segment_ids=None, softmax_scale=None,
                            splits=None):
    """``(dK, dV)`` from the CUDA kernel K3, summed over each kv head's
    q-head group (CUDA tensors only; arguments as ``_dq``).  bf16 / fp16
    take the tensor-core body, whose walk is split over ``splits`` blocks
    (default ``_dkv_splits`` for this card) with fp32 partial sums added
    in split order by a second kernel; fp32 takes the CUDA-core body,
    unsplit.  As for dQ, ``mma_launches`` counts the body the C launcher
    reports."""
    _check_bwd(q, k, v, do, lse, delta, segment_ids)
    seg_ptr, b, sq, sk, hq, hk, d, scale = _bwd_args(q, k, segment_ids,
                                                     softmax_scale)
    mma = q.dtype != torch.float32
    if not mma:
        if splits not in (None, 1):
            raise ValueError("flash_attention_bwd_dkv: the fp32 body does "
                             "not split")
        splits = 1
    elif splits is None:
        splits = _dkv_splits(b, hk, sk, hq // hk, _sm_count(q.device))
    elif splits < 1:
        raise ValueError(f"flash_attention_bwd_dkv: splits {splits} < 1")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = None
    if splits > 1:
        scratch = torch.empty(2, splits, b, sk, hk, d, dtype=torch.float32,
                              device=q.device)
    body = ctypes.c_int(-1)
    err = _bwd_lib().flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), seg_ptr, dk.data_ptr(),
        dv.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, sq, sk, hq, hk, d, scale, int(causal), splits,
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.byref(body))
    build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.mma_launches += body.value == _BODY_MMA
    flash_attention_bwd_dkv.noncausal_launches += not causal
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.mma_launches = 0
flash_attention_bwd_dkv.noncausal_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        segment_ids=None, softmax_scale=None):
    """``(dQ, dK, dV)``: delta in fp32, then K2 and K3 for CUDA tensors;
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         segment_ids=segment_ids,
                                         softmax_scale=softmax_scale)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, segment_ids=segment_ids,
              softmax_scale=softmax_scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """O = attention(q, k, v) with the forward kernel K1 and, backward, the
    kernels K2 and K3 (the JAX package's ``_flash`` custom_vjp).  It saves
    q, k, v, O and lse, as the JAX residuals do."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, softmax_scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     segment_ids=segment_ids,
                                     softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            segment_ids=segment_ids, softmax_scale=ctx.softmax_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                    softmax_scale=None):
    """Blockwise fused attention → O (drop-in for ops.attention's layout),
    differentiable through the backward kernels."""
    return FlashAttentionFunction.apply(q, k, v, segment_ids, causal,
                                        softmax_scale)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        # q k v seg out lse; b sq sk hq hk d; scale; causal dtype; stream;
        # the body launched (out)
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float,
                       I, I, P, P]
        fn.restype = I
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dq, dkv = lib.flash_attention_bwd_dq_launch, \
        lib.flash_attention_bwd_dkv_launch
    if dq.argtypes is None:
        # q k v dO lse delta seg dq; b sq sk hq hk d; scale; causal dtype;
        # stream; the body launched (out)
        dq.argtypes = [P] * 8 + [I] * 6 + [F, I, I, P, P]
        dq.restype = I
    if dkv.argtypes is None:
        # q k v dO lse delta seg dk dv scratch; b sq sk hq hk d; scale;
        # causal splits dtype; stream; the body launched (out)
        dkv.argtypes = [P] * 10 + [I] * 6 + [F, I, I, I, P, P]
        dkv.restype = I
    return lib
