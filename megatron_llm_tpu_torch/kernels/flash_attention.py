"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``megatron_llm_tpu/kernels/flash_attention.py``
(``_fwd_kernel`` via ``flash_attention``).  Layout as in JAX: q
``[b, sq, hq, d]``, k/v ``[b, sk, hk, d]``; returns O ``[b, sq, hq, d]`` in
q's dtype and, from ``flash_attention_fwd``, the fp32 logsumexp
``[b, hq, sq]``.  What bounds the kernel on the H100 and how it is laid out
is written at the top of the CUDA source.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises on a dtype, head size or layout the kernel does not take.  The
backward kernels (dQ, dK/dV) are a later slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

NO_KEY_LSE = -1e30  # lse of a row that sees no key (its O is 0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          segment_ids=None, softmax_scale=None):
    """The kernel's function in plain torch: ``(O, lse)`` with fp32 math."""
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    group = hq // hk
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hk, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * softmax_scale
    keep = _keep_mask(sq, sk, causal, segment_ids, q.device)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
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
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, o.data_ptr(),
        lse.data_ptr(), b, sq, sk, hq, hk, d, float(softmax_scale),
        int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                    softmax_scale=None):
    """Blockwise fused attention → O (drop-in for ops.attention's layout)."""
    return flash_attention_fwd(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               softmax_scale=softmax_scale)[0]


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float,
                       I, I, P]
        fn.restype = I
    return lib
