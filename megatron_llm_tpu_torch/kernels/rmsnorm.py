"""RMSNorm, forward and backward: Triton kernels (``rmsnorm_triton.py``),
each beside its plain PyTorch version, and the autograd Function that
joins them.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/rmsnorm.py``:
``_rms_fwd_kernel`` (via ``rmsnorm_pallas`` → ``_rms_fwd``):
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics, y in x's
dtype, plus the per-row ``rstd`` (fp32) the backward reads; and
``_rms_bwd_kernel`` (via ``_rms_bwd_vjp``): ``dx = rstd * (g - x̂ *
mean(g * x̂))`` with ``g = dy * w`` and ``x̂ = x * rstd``, dx in x's dtype.
dweight is the fp32 cross-row sum of ``dy * x̂``, cast to the weight's
dtype, computed outside the kernel as the JAX package does.

What bounds it on the H100: bytes.  It reads each element of x once and
writes y once with ~4 flops per element in between, two orders of
magnitude under the ~295 flop/byte where compute would matter.  So the
kernel is one pass: one program per row holds the whole row in registers
(hidden sizes up to 16384), reduces the sum of squares there, and writes y
and rstd without a second read of x.  Rows are independent programs, so
thousands of rows fill the card; a decode step's handful of rows cannot,
and is bound by launch latency instead.

The backward kernel is bound by bytes the same way: it reads x and dy
once and writes dx once, with one row reduction between.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``triton`` is imported, and a kernel compiled, at its first
CUDA launch.  The LayerNorm kernels are a later slice.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_HIDDEN = 16384


def _acc_dtype(x):
    """fp32 math, or fp64 for fp64 inputs (the gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def rmsnorm_plain(x, weight, eps: float = 1e-5):
    """``(y, rstd)`` in plain torch; rstd has x's leading dims plus a 1."""
    acc = _acc_dtype(x)
    xf = x.to(acc)
    rstd = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                       + eps)
    return (xf * rstd * weight.to(acc)).to(x.dtype), rstd


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


def rmsnorm_bwd_plain(x, weight, rstd, dy):
    """``(dx, dweight)`` in plain torch, from the forward's ``rstd``."""
    acc = _acc_dtype(x)
    xhat = x.to(acc) * rstd.to(acc)
    dyf = dy.to(acc)
    g = dyf * weight.to(acc)
    c = torch.mean(g * xhat, dim=-1, keepdim=True)
    dx = (rstd.to(acc) * (g - xhat * c)).to(x.dtype)
    return dx, _dweight(dyf, xhat, weight)


def _dweight(dyf, xhat, weight):
    """The cross-row sum of dy * x̂ in fp32, cast to the weight's dtype."""
    h = weight.shape[0]
    return (dyf * xhat).reshape(-1, h).sum(0).to(weight.dtype)


def rmsnorm_bwd(x, weight, rstd, dy):
    """``(dx, dweight)``: dx from the Triton kernel K5 for CUDA tensors
    (dweight beside it in torch), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, weight, rstd, dy)
    _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("rmsnorm backward: dy must match x in shape and "
                         "dtype and be contiguous")
    if rstd.dtype != torch.float32 or not rstd.is_contiguous() \
            or rstd.numel() * x.shape[-1] != x.numel():
        raise ValueError("rmsnorm backward: rstd must be the forward's "
                         "contiguous fp32 [rows, 1]")
    dx = launch_bwd_dx(x, weight, rstd, dy)
    xhat = x.float() * rstd
    return dx, _dweight(dy.float(), xhat, weight)


rmsnorm_bwd.launches = 0


def launch_bwd_dx(x, weight, rstd, dy):
    """dx from one launch of the Triton kernel K5, counted in
    ``rmsnorm_bwd.launches`` (CUDA operands as ``rmsnorm_bwd`` checks
    them)."""
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    if rows:
        import triton

        from .rmsnorm_triton import rms_bwd_kernel

        block = triton.next_power_of_2(hidden)
        with torch.cuda.device(x.device):
            rms_bwd_kernel[(rows,)](x, weight, dy, rstd, dx, hidden,
                                    BLOCK=block,
                                    num_warps=max(1, min(16, block // 256)))
        rmsnorm_bwd.launches += 1
    return dx


class RMSNormFunction(torch.autograd.Function):
    """y = rmsnorm(x, w) with the forward kernel K4 and, backward, the dx
    kernel K5 (the JAX package's ``rmsnorm_pallas`` custom_vjp).  It saves
    x, w and rstd, as the JAX residuals do."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rmsnorm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, rstd, dy.contiguous())
        return dx, dw, None


def rmsnorm(x, weight, eps: float = 1e-5):
    """RMSNorm output (the kernel's y), differentiable through K5."""
    return RMSNormFunction.apply(x, weight, eps)
