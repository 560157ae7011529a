"""Rotary position embeddings (mirror of ``megatron_llm_tpu/ops/rope.py``).

Interleaved-pair convention: the pairs rotated together are adjacent
elements ``x[..., 0::2], x[..., 1::2]`` (the reference/Meta layout the
JAX package and its HF weight converter assume), not HF's rotate-half.
Scaling: ``linear`` position interpolation, Llama-3.1's piecewise
``llama3`` frequency scaling, and ``yarn`` NTK-by-parts with the
attention temperature folded into the tables.
"""

from __future__ import annotations

import math

import torch


def llama3_scaled_inv_freq(inv_freq: torch.Tensor, factor: float,
                           low_freq_factor: float, high_freq_factor: float,
                           original_max_positions: int) -> torch.Tensor:
    wavelen = 2.0 * math.pi / inv_freq
    low_wavelen = original_max_positions / low_freq_factor
    high_wavelen = original_max_positions / high_freq_factor
    smooth = (original_max_positions / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    out = torch.where(wavelen > low_wavelen, inv_freq / factor, interp)
    return torch.where(wavelen < high_wavelen, inv_freq, out)


def yarn_scaled_inv_freq(inv_freq: torch.Tensor, factor: float,
                         beta_fast: float, beta_slow: float,
                         original_max_positions: int, head_dim: int,
                         theta: float,
                         attention_factor: float | None = None
                         ) -> tuple[torch.Tensor, float]:
    dim = head_dim

    def correction_dim(n_rot):
        return (dim * math.log(original_max_positions
                               / (n_rot * 2 * math.pi))
                ) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
        0.0, 1.0)
    extrap_w = 1.0 - ramp
    scaled = inv_freq / factor * (1.0 - extrap_w) + inv_freq * extrap_w
    if attention_factor is None:
        attention_factor = (0.1 * math.log(factor) + 1.0
                            if factor > 1 else 1.0)
    return scaled, float(attention_factor)


def precompute_rope_freqs(
    head_dim: int,
    max_positions: int,
    theta: float = 10000.0,
    scaling_factor: float = 1.0,
    scaling_type: str = "linear",
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_positions: int | None = None,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    attention_factor: float | None = None,
    dtype=torch.float32,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each [max_positions, head_dim//2]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                  / head_dim))
    table_scale = 1.0
    if scaling_type in ("llama3", "yarn") and scaling_factor != 1.0 \
            and not original_max_positions:
        raise ValueError(
            f"{scaling_type} rope scaling needs original_max_positions "
            "(the pre-extension context length)")
    if scaling_type == "llama3":
        if scaling_factor != 1.0:
            inv_freq = llama3_scaled_inv_freq(
                inv_freq, scaling_factor, low_freq_factor,
                high_freq_factor, original_max_positions)
        t = torch.arange(max_positions, dtype=torch.float32)
    elif scaling_type == "yarn":
        if scaling_factor != 1.0:
            inv_freq, table_scale = yarn_scaled_inv_freq(
                inv_freq, scaling_factor, beta_fast, beta_slow,
                original_max_positions, head_dim, theta,
                attention_factor)
        t = torch.arange(max_positions, dtype=torch.float32)
    elif scaling_type == "linear":
        t = torch.arange(max_positions, dtype=torch.float32) / scaling_factor
    else:
        raise ValueError(f"unknown rope scaling_type {scaling_type!r} "
                         "(want 'linear' | 'llama3' | 'yarn')")
    freqs = torch.outer(t, inv_freq)
    cos = (table_scale * torch.cos(freqs)).to(dtype)
    sin = (table_scale * torch.sin(freqs)).to(dtype)
    return cos.to(device), sin.to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               position_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by the tables; optional
    ``position_ids`` [batch, seq] select arbitrary (e.g. cached) rows."""
    seq_axis = x.ndim - 3
    if position_ids is None:
        seq = x.shape[seq_axis]
        shape = [1] * x.ndim
        shape[seq_axis] = seq
        shape[-1] = cos.shape[-1]
        cos_t = cos[:seq].reshape(shape)
        sin_t = sin[:seq].reshape(shape)
    else:
        cos_t = cos[position_ids].unsqueeze(-2)
        sin_t = sin[position_ids].unsqueeze(-2)
    cos_t = cos_t.float()
    sin_t = sin_t.float()
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos_t - x2 * sin_t
    r2 = x2 * cos_t + x1 * sin_t
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
