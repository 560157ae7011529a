"""The Triton RMSNorm forward kernel (see ``rmsnorm.py`` for its contract,
its plain version and its launcher).

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
