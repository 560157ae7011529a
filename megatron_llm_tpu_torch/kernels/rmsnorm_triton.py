"""The Triton RMSNorm and LayerNorm kernels: forward, RMSNorm's dx and
dweight in one pass (with a column sum of its partial rows), LayerNorm's
dx (see ``rmsnorm.py`` for their contracts, plain versions and
launchers).

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
def rms_bwd_kernel(x_ptr, w_ptr, dy_ptr, rstd_ptr, dx_ptr, part_ptr, rows,
                   hidden, rows_per_prog, BLOCK: tl.constexpr):
    # one program per block of ``rows_per_prog`` consecutive rows, with the
    # row, w and an fp32 accumulator in registers: for each row, x and dy
    # once from device memory, the forward's rstd, one fp32 reduction for
    # c = mean(g * x̂), dx = rstd (g - x̂ c), and dy * x̂ added into the
    # accumulator, stored at the end as the program's partial dweight row
    # part[pid, :] (colsum_kernel adds the partial rows); masked lanes load
    # 0 and so add 0.  The whole row is held at every hidden size up to the
    # 16384 cap.  Triton's n_regs / n_spills, 4096 rows bf16
    # (kernels/norm_probe.py; NVIDIA H100 80GB HBM3, 700 W): hidden 4096
    # 58 / 0, 4544 and 8192 116 / 0, 16384 128 / 42.  At 16384 the spills
    # cost less than a walk of the row in 8192-column chunks that spilled
    # nothing (90 / 0; the row read a second time from cache, the partial
    # row added to in memory): 0.1825 ms against 0.2336, both bodies built
    # by an earlier version of norm_probe.py
    pid = tl.program_id(0)
    start = pid * rows_per_prog
    end = tl.minimum(start + rows_per_prog, rows)
    offs = tl.arange(0, BLOCK)
    mask = offs < hidden
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for row in range(start, end):
        base = row.to(tl.int64) * hidden
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + base + offs, mask=mask,
                     other=0.0).to(tl.float32)
        rstd = tl.load(rstd_ptr + row)
        g = dy * w
        xhat = x * rstd
        c = tl.sum(g * xhat, axis=0) / hidden
        dx = rstd * (g - xhat * c)
        tl.store(dx_ptr + base + offs, dx.to(dx_ptr.dtype.element_ty),
                 mask=mask)
        acc += dy * xhat
    tl.store(part_ptr + pid.to(tl.int64) * hidden + offs, acc, mask=mask)


@triton.jit
def colsum_kernel(part_ptr, out_ptr, programs, hidden, BLOCK_P: tl.constexpr,
                  BLOCK_C: tl.constexpr):
    # out[c] = sum over p of part[p, c] for BLOCK_C columns a program: tiles
    # of BLOCK_P partial rows in order, each tile summed over its rows, the
    # fp32 total cast to out's dtype (a fixed order: the same bits every
    # run)
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < hidden
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, programs, BLOCK_P):
        p = p0 + tl.arange(0, BLOCK_P)
        tile = tl.load(part_ptr + p[:, None].to(tl.int64) * hidden
                       + cols[None, :],
                       mask=(p[:, None] < programs) & cmask[None, :],
                       other=0.0)
        acc += tl.sum(tile, axis=0)
    tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=cmask)


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
