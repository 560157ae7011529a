"""The Triton RMSNorm kernels, forward and dx (see ``rmsnorm.py`` for
their contracts, plain versions and launchers).

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
