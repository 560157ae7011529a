"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX parameter pytree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameter dict: the same keys and the same stacked ``[L, ...]``
shapes and ``x @ w`` orientation, leaf for leaf, as torch tensors:

- ``embedding.word`` (and ``embedding.position`` for learned positions);
- ``layers.attn.{wq, wk, wv, wo}`` (+ biases where the config has them);
- ``layers.mlp.{w_gate, w_up, w_down}``;
- ``layers.{input_norm, post_attn_norm}.scale`` (``mlp_norm`` for
  Falcon-40B, ``bias`` for LayerNorm);
- ``final_norm.scale`` and ``lm_head``.

A tree quantized by the JAX ``ops/quant.quantize_params`` crosses the same
way: its ``{"q", "scale"}`` leaves (int8 codes, packed int4 codes, fp32
scales) keep their dtypes and bits.  Only numpy crosses the boundary, so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays → the same nesting of torch tensors on
    ``device`` (default ``cuda``)."""
    device = torch.device("cuda" if device is None else device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_torch(tree, device)
