"""The Triton RMSNorm and LayerNorm kernels, forward and dx (see
``rmsnorm.py`` for their contracts, plain versions and launchers).

This module imports ``triton`` at load, so only the launching function in
``rmsnorm.py`` imports it, at the first launch on a CUDA tensor.
"""

import triton
import triton.language as tl


@triton.jit
def rms_fwd_kernel(x_ptr, w_ptr, y_ptr, rstd_ptr, hidden, eps,
                   BLOCK: tl.constexpr):
    # one program per row: the whole row is loaded once into registers,
    # reduced in fp32, scaled and stored; rstd goes out beside y
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < hidden
    x = tl.load(x_ptr + row * hidden + offs, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / hidden
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * rstd * w
    tl.store(y_ptr + row * hidden + offs, y.to(y_ptr.dtype.element_ty),
             mask=mask)
    tl.store(rstd_ptr + row, rstd)


@triton.jit
def rms_bwd_kernel(x_ptr, w_ptr, dy_ptr, rstd_ptr, dx_ptr, hidden,
                   BLOCK: tl.constexpr):
    # one program per row: x, dy and w in registers, the forward's rstd,
    # one fp32 reduction for mean(g * x̂), then dx = rstd (g - x̂ c)
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < hidden
    x = tl.load(x_ptr + row * hidden + offs, mask=mask,
                other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + row * hidden + offs, mask=mask,
                 other=0.0).to(tl.float32)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    rstd = tl.load(rstd_ptr + row)
    g = dy * w
    xhat = x * rstd
    c = tl.sum(g * xhat, axis=0) / hidden
    dx = rstd * (g - xhat * c)
    tl.store(dx_ptr + row * hidden + offs, dx.to(dx_ptr.dtype.element_ty),
             mask=mask)


@triton.jit
def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, hidden,
                  eps, HAS_BIAS: tl.constexpr, BLOCK: tl.constexpr):
    # one program per row, as rms_fwd_kernel; the lanes past ``hidden``
    # load 0, but x - mean is -mean there, so it is masked to 0 before the
    # variance sum
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < hidden
    x = tl.load(x_ptr + row * hidden + offs, mask=mask,
                other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / hidden
    xc = tl.where(mask, x - mean, 0.0)
    rstd = tl.rsqrt(tl.sum(xc * xc, axis=0) / hidden + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = xc * rstd * w
    if HAS_BIAS:
        y += tl.load(b_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * hidden + offs, y.to(y_ptr.dtype.element_ty),
             mask=mask)
    tl.store(mean_ptr + row, mean)
    tl.store(rstd_ptr + row, rstd)


@triton.jit
def ln_bwd_kernel(x_ptr, w_ptr, dy_ptr, mean_ptr, rstd_ptr, dx_ptr, hidden,
                  BLOCK: tl.constexpr):
    # one program per row: x, dy and w in registers, the forward's mean and
    # rstd, two fp32 row sums (mean(g), mean(g * x̂)), then
    # dx = rstd (g - mean(g) - x̂ mean(g x̂)); x̂ is masked to 0 past
    # ``hidden`` (g is 0 there already: dy and w load 0)
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < hidden
    x = tl.load(x_ptr + row * hidden + offs, mask=mask,
                other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + row * hidden + offs, mask=mask,
                 other=0.0).to(tl.float32)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.load(mean_ptr + row)
    rstd = tl.load(rstd_ptr + row)
    g = dy * w
    xhat = tl.where(mask, (x - mean) * rstd, 0.0)
    c1 = tl.sum(g, axis=0) / hidden
    c2 = tl.sum(g * xhat, axis=0) / hidden
    dx = rstd * (g - c1 - xhat * c2)
    tl.store(dx_ptr + row * hidden + offs, dx.to(dx_ptr.dtype.element_ty),
             mask=mask)
