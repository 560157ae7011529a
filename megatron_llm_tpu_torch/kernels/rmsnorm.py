"""RMSNorm forward: a Triton kernel (``rmsnorm_triton.py``) and its plain
PyTorch version.

Replaces the TPU kernel ``megatron_llm_tpu/kernels/rmsnorm.py``
(``_rms_fwd_kernel`` via ``rmsnorm_pallas`` → ``_rms_fwd``):
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics, y in x's
dtype, plus the per-row ``rstd`` (fp32) the backward kernel will need.

What bounds it on the H100: bytes.  It reads each element of x once and
writes y once with ~4 flops per element in between, two orders of
magnitude under the ~295 flop/byte where compute would matter.  So the
kernel is one pass: one program per row holds the whole row in registers
(hidden sizes up to 16384), reduces the sum of squares there, and writes y
and rstd without a second read of x.  Rows are independent programs, so
thousands of rows fill the card; a decode step's handful of rows cannot,
and is bound by launch latency instead.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``triton`` is imported, and the kernel compiled, at the first
CUDA launch.  The backward and the LayerNorm kernels are later slices.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_HIDDEN = 16384


def rmsnorm_plain(x, weight, eps: float = 1e-5):
    """``(y, rstd)`` in plain torch; rstd has x's leading dims plus a 1."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                       + eps)
    return (xf * rstd * weight.float()).to(x.dtype), rstd


def _check(x, weight):
    if not (x.is_cuda and weight.is_cuda):
        raise ValueError("rmsnorm: x and weight must be CUDA tensors")
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}/{weight.dtype}")
    if weight.ndim != 1 or weight.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} does not "
                         f"match hidden size {x.shape[-1]}")
    if x.shape[-1] > _MAX_HIDDEN:
        raise ValueError(f"rmsnorm: hidden size {x.shape[-1]} above "
                         f"{_MAX_HIDDEN} (one row per program)")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm: x and weight must be contiguous")


def rmsnorm_fwd(x, weight, eps: float = 1e-5):
    """``(y, rstd)``: the Triton kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    _check(x, weight)
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)
    if rows:
        import triton

        from .rmsnorm_triton import rms_fwd_kernel

        block = triton.next_power_of_2(hidden)
        with torch.cuda.device(x.device):
            rms_fwd_kernel[(rows,)](x, weight, y, rstd, hidden, float(eps),
                                    BLOCK=block,
                                    num_warps=max(1, min(16, block // 256)))
        rmsnorm_fwd.launches += 1
    return y, rstd


rmsnorm_fwd.launches = 0


def rmsnorm(x, weight, eps: float = 1e-5):
    """RMSNorm output (the kernel's y)."""
    return rmsnorm_fwd(x, weight, eps)[0]
