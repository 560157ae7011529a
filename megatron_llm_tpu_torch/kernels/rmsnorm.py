"""RMSNorm and LayerNorm, forward and backward: Triton kernels
(``rmsnorm_triton.py``), each beside its plain PyTorch version, and the
autograd Functions that join them.

Replaces the TPU kernels of ``megatron_llm_tpu/kernels/rmsnorm.py``:
``_rms_fwd_kernel`` (via ``rmsnorm_pallas`` → ``_rms_fwd``):
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics, y in x's
dtype, plus the per-row ``rstd`` (fp32) the backward reads; and
``_rms_bwd_kernel`` (via ``_rms_bwd_vjp``): ``dx = rstd * (g - x̂ *
mean(g * x̂))`` with ``g = dy * w`` and ``x̂ = x * rstd``, dx in x's dtype,
and dweight, the fp32 cross-row sum of ``dy * x̂`` cast to the weight's
dtype, which the JAX package leaves to XLA beside its kernel ("cross-row
reduction, XLA territory"; XLA fuses it into one pass over x and dy).
Here it is in the kernel: eager torch would take four or five passes.

The LayerNorm pair replaces ``_ln_fwd_kernel`` (via ``layernorm_pallas`` →
``_ln_fwd``): ``y = (x - mean) * rstd * w (+ b)`` with the fp32 per-row
``mean`` and ``rstd`` beside it; and ``_ln_bwd_kernel`` (via
``_ln_bwd_vjp``): ``dx = rstd * (g - mean(g) - x̂ * mean(g * x̂))`` with
``g = dy * w`` and ``x̂ = (x - mean) * rstd``.  dweight and dbias are the
fp32 cross-row sums of ``dy * x̂`` and ``dy``, cast to the weight's dtype,
which JAX leaves to XLA beside its kernel; here they are in the kernel's
pass, as K5's dweight.  The JAX package pads rows and never
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
reductions between.  K5 also sums dweight in the same pass: one program
per block of consecutive rows (``_bwd_rows_per_program``: about four
programs a SM) adds ``dy * x̂`` of its rows into an fp32 register row and
stores it as its partial row; a second small kernel adds the partial rows
column by column in a fixed order, so the result is the same bit for bit
from run to run, with no atomics.  The partials are programs x hidden x 4
bytes (8 MB at Llama-2-7B's training rows).  The row is held whole up to
the 16384 cap, where it spills a little (registers, spills and times
beside ``rms_bwd_kernel``).  K7 is the same design with a second
partial row, Σ dy, for dbias (none without a bias); one column-sum launch
adds both sets of partial rows.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``triton`` is imported, and a kernel compiled, at its first
CUDA launch; every launch goes through ``_launch``, which reports a
specialisation seen for the first time to the recompilation guard
(``analysis/sanitizers.no_recompiles``).
"""

from __future__ import annotations

import torch

from ..analysis.sanitizers import note_triton_kernel

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_HIDDEN = 16384


def _launch(kernel, grid, *args, **kw):
    """Launch a Triton kernel over ``grid`` and return its compiled
    object; Triton returns the cached object unless it compiled anew."""
    compiled = kernel[grid](*args, **kw)
    note_triton_kernel(compiled, getattr(kernel, "__name__", "triton"))
    return compiled


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
            _launch(rms_fwd_kernel, (rows,), x, weight, y, rstd, hidden,
                    float(eps), BLOCK=block, num_warps=_warps(block))
        rmsnorm_fwd.launches += 1
    return y, rstd


rmsnorm_fwd.launches = 0


_BWD_PROGRAMS_PER_SM = 4
# colsum_kernel's tile: partial rows x columns a step
_COLSUM_ROWS, _COLSUM_COLS = 128, 32


def _bwd_rows_per_program(rows: int, sm_count: int) -> int:
    """Rows R of each program of the one-pass backward: the fewest that
    keep the programs at about ``_BWD_PROGRAMS_PER_SM`` a SM.  Program p
    takes rows [p R, min((p + 1) R, rows)), so ceil(rows / R) programs
    cover every row once and none is empty."""
    return max(1, -(-rows // (_BWD_PROGRAMS_PER_SM * sm_count)))


def _two_stage_sum_plain(t, rows_per_program: int):
    """The column sum of ``t`` [rows, h] in the one-pass backward's
    partition: each program's rows summed into a partial row, then the
    partial rows added over the programs in order (``colsum_kernel`` takes
    them in tiles of ``_COLSUM_ROWS``, in order; the two agree to the
    rounding of the sums)."""
    rows, h = t.shape
    programs = -(-rows // rows_per_program)
    if programs == 0:
        return t.new_zeros(h)
    pad = programs * rows_per_program - rows
    parts = torch.cat([t, t.new_zeros(pad, h)]).reshape(
        programs, rows_per_program, h).sum(1)
    out = parts[0].clone()
    for p in range(1, programs):
        out += parts[p]
    return out


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
    """``(dx, dweight)``: the Triton kernel K5 for CUDA tensors, the plain
    version for CPU tensors.  K5 is two launches, counted as one: one pass
    over x and dy writes dx and each program's fp32 partial dweight row,
    then ``colsum_kernel`` adds the partial rows in a fixed order (the
    same bits every run) and casts to the weight's dtype."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, weight, rstd, dy)
    _check(x, weight)
    _check_bwd(x, dy, rstd)
    dx, dw, _ = launch_rms_bwd(x, weight, rstd, dy)
    return dx, dw


def launch_rms_bwd(x, weight, rstd, dy):
    """``(dx, dweight, the compiled one-pass kernel or None)`` from K5's
    two launches, counted as one in ``rmsnorm_bwd.launches`` (CUDA
    operands as ``rmsnorm_bwd`` checks them)."""
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    dw = torch.zeros_like(weight)
    if not rows:
        return dx, dw, None
    import triton

    from .rmsnorm_triton import colsum_kernel, rms_bwd_kernel

    block = triton.next_power_of_2(hidden)
    per = _bwd_rows_per_program(
        rows, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    programs = -(-rows // per)
    part = torch.empty(programs, hidden, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        compiled = _launch(
            rms_bwd_kernel, (programs,), x, weight, dy, rstd, dx, part,
            rows, hidden, per, BLOCK=block, num_warps=_warps(block))
        _launch(colsum_kernel, (triton.cdiv(hidden, _COLSUM_COLS), 1),
                part, dw, programs, hidden, BLOCK_P=_COLSUM_ROWS,
                BLOCK_C=_COLSUM_COLS, num_warps=4)
    rmsnorm_bwd.launches += 1
    return dx, dw, compiled


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


class RMSNormFunction(torch.autograd.Function):
    """y = rmsnorm(x, w) with the forward kernel K4 and, backward, K5 (dx
    and dweight; the JAX package's ``rmsnorm_pallas`` custom_vjp).  It
    saves x, w and rstd, as the JAX residuals do."""

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
# LayerNorm (K6 forward, K7 backward)
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
            _launch(ln_fwd_kernel, (rows,), x, weight,
                    weight if bias is None else bias, y, mean, rstd, hidden,
                    float(eps), HAS_BIAS=bias is not None, BLOCK=block,
                    num_warps=_warps(block))
        layernorm_fwd.launches += 1
    return y, mean, rstd


layernorm_fwd.launches = 0


def layernorm_bwd_plain(x, weight, mean, rstd, dy, has_bias: bool = True,
                        rows_per_program=None):
    """``(dx, dweight, dbias)`` in plain torch from the forward's ``mean``
    and ``rstd``; dbias is None without a bias.  With ``rows_per_program``
    the column sums run in K7's partition (``_two_stage_sum_plain``), else
    in one sum."""
    acc = _acc_dtype(x)
    xhat = (x.to(acc) - mean.to(acc)) * rstd.to(acc)
    dyf = dy.to(acc)
    g = dyf * weight.to(acc)
    c1 = torch.mean(g, dim=-1, keepdim=True)
    c2 = torch.mean(g * xhat, dim=-1, keepdim=True)
    dx = (rstd.to(acc) * (g - c1 - xhat * c2)).to(x.dtype)
    h = weight.shape[0]
    if rows_per_program is None:
        colsum = lambda t: t.reshape(-1, h).sum(0)  # noqa: E731
    else:
        colsum = lambda t: _two_stage_sum_plain(  # noqa: E731
            t.reshape(-1, h), rows_per_program)
    return (dx, colsum(dyf * xhat).to(weight.dtype),
            colsum(dyf).to(weight.dtype) if has_bias else None)


def layernorm_bwd(x, weight, mean, rstd, dy, has_bias: bool = True):
    """``(dx, dweight, dbias)``: the Triton kernel K7 for CUDA tensors, the
    plain version for CPU tensors.  K7 is two launches, counted as one:
    one pass over x and dy writes dx and each program's fp32 partial
    dweight (and dbias) row, then ``colsum_kernel`` adds the partial rows
    in a fixed order and casts to the weight's dtype."""
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, weight, mean, rstd, dy, has_bias)
    _check(x, weight)
    _check_bwd(x, dy, mean, rstd)
    dx, dw, db, _ = launch_ln_bwd(x, weight, mean, rstd, dy, has_bias)
    return dx, dw, db


layernorm_bwd.launches = 0


def launch_ln_bwd(x, weight, mean, rstd, dy, has_bias: bool = True):
    """``(dx, dweight, dbias or None, the compiled one-pass kernel or
    None)`` from K7's two launches, counted as one in
    ``layernorm_bwd.launches`` (CUDA operands as ``layernorm_bwd`` checks
    them)."""
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    sums = torch.zeros((1 + has_bias, hidden), dtype=weight.dtype,
                       device=x.device)
    db = sums[1] if has_bias else None
    if not rows:
        return dx, sums[0], db, None
    import triton

    from .rmsnorm_triton import colsum_kernel, ln_bwd_kernel

    block = triton.next_power_of_2(hidden)
    per = _bwd_rows_per_program(
        rows, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    programs = -(-rows // per)
    part = torch.empty(1 + has_bias, programs, hidden, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        compiled = _launch(
            ln_bwd_kernel, (programs,), x, weight, dy, mean, rstd, dx, part,
            rows, hidden, per, HAS_BIAS=has_bias, BLOCK=block,
            num_warps=_warps(block))
        _launch(colsum_kernel,
                (triton.cdiv(hidden, _COLSUM_COLS), 1 + has_bias), part,
                sums, programs, hidden, BLOCK_P=_COLSUM_ROWS,
                BLOCK_C=_COLSUM_COLS, num_warps=4)
    layernorm_bwd.launches += 1
    return dx, sums[0], db, compiled


class LayerNormFunction(torch.autograd.Function):
    """y = layernorm(x, w, b) with the forward kernel K6 and, backward, K7
    (dx, dweight, dbias; the JAX package's ``layernorm_pallas`` custom_vjp).  It
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
