"""Activation zoo: the GLU family over a doubled-width projection split in
half, and the gelus (mirror of ``megatron_llm_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _split_glu(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.chunk(x, 2, dim=-1)


def liglu(x):
    a, b = _split_glu(x)
    return a * b


def geglu(x):
    a, b = _split_glu(x)
    return F.gelu(a, approximate="tanh") * b


def reglu(x):
    a, b = _split_glu(x)
    return F.relu(a) * b


def swiglu(x):
    a, b = _split_glu(x)
    return F.silu(a) * b


def gelu(x):
    # tanh approximation, as the JAX package and HF Falcon/GPT2 use
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def squared_relu(x):
    return torch.square(F.relu(x))


ACTIVATIONS = {
    "liglu": liglu,
    "geglu": geglu,
    "reglu": reglu,
    "swiglu": swiglu,
    "gelu": gelu,
    "gelu_exact": gelu_exact,
    "squared_relu": squared_relu,
    "relu": F.relu,
    "silu": F.silu,
}

GLU_ACTIVATIONS = {"liglu", "geglu", "reglu", "swiglu"}


def get_activation(name: str):
    return ACTIVATIONS[name]


def is_glu(name: str) -> bool:
    return name in GLU_ACTIVATIONS
