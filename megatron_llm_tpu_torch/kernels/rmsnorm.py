"""RMSNorm and LayerNorm, forward and backward: Triton kernels
(``rmsnorm_triton.py``), each beside its plain PyTorch version, and the
autograd Functions that join them.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/rmsnorm.py``:
``_rms_fwd_kernel`` (via ``rmsnorm_pallas`` → ``_rms_fwd``):
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics, y in x's
dtype, plus the per-row ``rstd`` (fp32) the backward reads; and
``_rms_bwd_kernel`` (via ``_rms_bwd_vjp``): ``dx = rstd * (g - x̂ *
mean(g * x̂))`` with ``g = dy * w`` and ``x̂ = x * rstd``, dx in x's dtype.
dweight is the fp32 cross-row sum of ``dy * x̂``, cast to the weight's
dtype, computed outside the kernel as the JAX package does.

The LayerNorm pair replaces ``_ln_fwd_kernel`` (via ``layernorm_pallas`` →
``_ln_fwd``): ``y = (x - mean) * rstd * w (+ b)`` with the fp32 per-row
``mean`` and ``rstd`` beside it; and ``_ln_bwd_kernel`` (via
``_ln_bwd_vjp``): ``dx = rstd * (g - mean(g) - x̂ * mean(g * x̂))`` with
``g = dy * w`` and ``x̂ = (x - mean) * rstd``.  dweight and dbias are the
fp32 cross-row sums of ``dy * x̂`` and ``dy``, cast to the weight's dtype,
outside the kernel as in JAX.  The JAX package pads rows and never
columns; here a row of a hidden size that is not a power of two (Falcon's
4544) sits in a power-of-two block whose masked lanes load 0, and the
kernels re-mask ``x - mean`` there before every row sum.

What bounds it on the H100: bytes.  It reads each element of x once and
writes y once with ~4 flops per element in between, two orders of
magnitude under the ~295 flop/byte where compute would matter.  So the
kernel is one pass: one program per row holds the whole row in registers
(hidden sizes up to 16384), reduces the sum of squares there, and writes y
and rstd without a second read of x.  Rows are independent programs, so
thousands of rows fill the card; a decode step's handful of rows cannot,
and is bound by launch latency instead.

The backward kernels are bound by bytes the same way: each reads x and dy
once and writes dx once, with one (RMSNorm) or two (LayerNorm) row
reductions between.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``triton`` is imported, and a kernel compiled, at its first
CUDA launch.
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


def _check(x, weight, bias=None):
    if bias is not None and (bias.shape != weight.shape
                             or bias.dtype != weight.dtype
                             or not bias.is_cuda or not bias.is_contiguous()):
        raise ValueError("layernorm: bias must match the weight and be a "
                         "contiguous CUDA tensor")
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
    rstd = _row_stat(x)
    if rows:
        import triton

        from .rmsnorm_triton import rms_fwd_kernel

        block = triton.next_power_of_2(hidden)
        with torch.cuda.device(x.device):
            rms_fwd_kernel[(rows,)](x, weight, y, rstd, hidden, float(eps),
                                    BLOCK=block, num_warps=_warps(block))
        rmsnorm_fwd.launches += 1
    return y, rstd


rmsnorm_fwd.launches = 0


def _row_stat(x):
    """An fp32 per-row statistic: x's leading dims plus a 1."""
    return torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)


def _warps(block: int) -> int:
    """One warp per 256 lanes of the row, 1 to 16: at most 16 fp32 values
    of each live array per thread."""
    return max(1, min(16, block // 256))


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
    _check_bwd(x, dy, rstd)
    dx = launch_bwd_dx(x, weight, rstd, dy)
    xhat = x.float() * rstd
    return dx, _dweight(dy.float(), xhat, weight)


rmsnorm_bwd.launches = 0


def _check_bwd(x, dy, *stats):
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("norm backward: dy must match x in shape and dtype "
                         "and be contiguous")
    for t in stats:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() * x.shape[-1] != x.numel():
            raise ValueError("norm backward: the forward's statistics must "
                             "be contiguous fp32 [rows, 1]")


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
                                    BLOCK=block, num_warps=_warps(block))
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


# ---------------------------------------------------------------------------
# LayerNorm (K6 forward, K7 dx)
# ---------------------------------------------------------------------------


def layernorm_plain(x, weight, bias=None, eps: float = 1e-5):
    """``(y, mean, rstd)`` in plain torch; the statistics have x's leading
    dims plus a 1."""
    acc = _acc_dtype(x)
    xf = x.to(acc)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    y = xc * rstd * weight.to(acc)
    if bias is not None:
        y = y + bias.to(acc)
    return y.to(x.dtype), mean, rstd


def layernorm_fwd(x, weight, bias=None, eps: float = 1e-5):
    """``(y, mean, rstd)``: the Triton kernel K6 for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps)
    _check(x, weight, bias)
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    mean, rstd = _row_stat(x), _row_stat(x)
    if rows:
        import triton

        from .rmsnorm_triton import ln_fwd_kernel

        block = triton.next_power_of_2(hidden)
        with torch.cuda.device(x.device):
            # without a bias the weight stands in for its pointer, unread
            ln_fwd_kernel[(rows,)](x, weight, weight if bias is None else bias,
                                   y, mean, rstd, hidden, float(eps),
                                   HAS_BIAS=bias is not None, BLOCK=block,
                                   num_warps=_warps(block))
        layernorm_fwd.launches += 1
    return y, mean, rstd


layernorm_fwd.launches = 0


def layernorm_bwd_plain(x, weight, mean, rstd, dy, has_bias: bool = True):
    """``(dx, dweight, dbias)`` in plain torch from the forward's ``mean``
    and ``rstd``; dbias is None without a bias."""
    acc = _acc_dtype(x)
    xhat = (x.to(acc) - mean.to(acc)) * rstd.to(acc)
    dyf = dy.to(acc)
    g = dyf * weight.to(acc)
    c1 = torch.mean(g, dim=-1, keepdim=True)
    c2 = torch.mean(g * xhat, dim=-1, keepdim=True)
    dx = (rstd.to(acc) * (g - c1 - xhat * c2)).to(x.dtype)
    return (dx, _dweight(dyf, xhat, weight),
            _dbias(dyf, weight) if has_bias else None)


def _dbias(dyf, weight):
    """The cross-row sum of dy in fp32, cast to the weight's dtype."""
    return dyf.reshape(-1, weight.shape[0]).sum(0).to(weight.dtype)


def layernorm_bwd(x, weight, mean, rstd, dy, has_bias: bool = True):
    """``(dx, dweight, dbias)``: dx from the Triton kernel K7 for CUDA
    tensors (dweight and dbias beside it in torch), the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, weight, mean, rstd, dy, has_bias)
    _check(x, weight)
    _check_bwd(x, dy, mean, rstd)
    dx = launch_ln_bwd_dx(x, weight, mean, rstd, dy)
    dyf = dy.float()
    xhat = (x.float() - mean) * rstd
    return (dx, _dweight(dyf, xhat, weight),
            _dbias(dyf, weight) if has_bias else None)


layernorm_bwd.launches = 0


def launch_ln_bwd_dx(x, weight, mean, rstd, dy):
    """dx from one launch of the Triton kernel K7, counted in
    ``layernorm_bwd.launches`` (CUDA operands as ``layernorm_bwd`` checks
    them)."""
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    if rows:
        import triton

        from .rmsnorm_triton import ln_bwd_kernel

        block = triton.next_power_of_2(hidden)
        with torch.cuda.device(x.device):
            ln_bwd_kernel[(rows,)](x, weight, dy, mean, rstd, dx, hidden,
                                   BLOCK=block, num_warps=_warps(block))
        layernorm_bwd.launches += 1
    return dx


class LayerNormFunction(torch.autograd.Function):
    """y = layernorm(x, w, b) with the forward kernel K6 and, backward, the
    dx kernel K7 (the JAX package's ``layernorm_pallas`` custom_vjp).  It
    saves x, w, mean and rstd, as the JAX residuals do; ``bias`` may be
    None (``has_bias``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layernorm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(x, weight, mean, rstd, dy.contiguous(),
                                   ctx.has_bias)
        return dx, dw, db, None


def layernorm(x, weight, bias=None, eps: float = 1e-5):
    """LayerNorm output (K6's y), differentiable through K7."""
    return LayerNormFunction.apply(x, weight, bias, eps)
