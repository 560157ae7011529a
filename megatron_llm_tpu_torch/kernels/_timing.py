"""Device timing, the H100's peak rates and the norm shapes that
``chip_smoke.py`` and the tuning probes (``attention_probe.py``,
``norm_probe.py``) share.  Nothing here is on a model's path."""

from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core
# operations/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_OPS_S = 989e12
PEAK_FP32_OPS_S = 67e12  # outside the tensor cores (norms' fp32 math)

# the LayerNorm shapes timed: Falcon-7B's and GPT-1.3B's training rows
LN_SHAPES = (("falcon-7b rows 2048 h 4544", 2048, 4544),
             ("gpt-1.3b rows 4096 h 2048", 4096, 2048))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's launch cost
    (a Triton launch takes longer than a small kernel runs) is not timed.
    Inputs stay where the previous call left them (L2-warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` between CUDA events, without a
    graph (for calls that run autograd, whose launches take far less time
    than their kernels here)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_BF16_OPS_S):
    """(least milliseconds, "bytes" | "operations") on an H100."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ln_inputs(rows: int, h: int, gen, dev):
    """LayerNorm's x, weight and bias (bf16) for a timed shape."""
    x = (2.0 * torch.randn(rows, h, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(h, generator=gen, device=dev)
         ).to(torch.bfloat16)
    b = (0.1 * torch.randn(h, generator=gen, device=dev)).to(torch.bfloat16)
    return x, w, b
