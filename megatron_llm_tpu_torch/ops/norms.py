"""Normalization ops with fp32 statistics (mirror of
``megatron_llm_tpu/ops/norms.py``).

``impl="xla"`` is the plain torch math (the JAX package's XLA path);
``impl="pallas"`` keeps the JAX package's name and selects the port's
autograd Functions of ``kernels/rmsnorm.py``, RMSNorm's or LayerNorm's:
the Triton forward and dx kernels on CUDA tensors, their plain versions
on CPU tensors, so the same call serves inference and training.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm_apply(norm_type: str, x, params: dict, eps: float,
               impl: str = "xla") -> torch.Tensor:
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown norm impl {impl!r} (want 'xla'|'pallas')")
    if norm_type == "rmsnorm":
        if impl == "pallas":
            from ..kernels.rmsnorm import rmsnorm

            return rmsnorm(x.contiguous(), params["scale"], eps)
        return rmsnorm_ref(x, params["scale"], eps)
    if norm_type == "layernorm":
        if impl == "pallas":
            from ..kernels.rmsnorm import layernorm

            return layernorm(x.contiguous(), params["scale"],
                             params.get("bias"), eps)
        return layernorm_ref(x, params["scale"], params.get("bias"), eps)
    raise ValueError(f"unknown norm type {norm_type}")


def norm_init(norm_type: str, hidden: int, dtype=torch.float32,
              device=None) -> dict:
    if norm_type == "rmsnorm":
        return {"scale": torch.ones(hidden, dtype=dtype, device=device)}
    if norm_type == "layernorm":
        return {"scale": torch.ones(hidden, dtype=dtype, device=device),
                "bias": torch.zeros(hidden, dtype=dtype, device=device)}
    raise ValueError(f"unknown norm type {norm_type}")
