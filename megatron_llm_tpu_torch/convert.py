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
- ``final_norm.scale`` and ``lm_head``;
- the encoder families' trees as they are (``models/encdec.py``,
  ``biencoder.py``, ``tasks/``): BERT's ``embedding.tokentype``,
  ``embed_norm``, ``lm_head.{dense, dense_bias, norm, bias}``, ``pooler``
  and ``binary_head``; T5's ``encoder`` / ``decoder`` stacks, its
  ``cross`` subtree stacked ``[n_decoder_layers, ...]``, ``enc_norm``,
  ``dec_norm`` and ``lm_head_bias``; a biencoder's ``query`` and
  ``context`` towers (a shared one has no ``context``) and
  ``projection``; the tasks' ``classification_head`` and
  ``multichoice_head``.

A tree quantized by the JAX ``ops/quant.quantize_params`` crosses the same
way: its ``{"q", "scale"}`` leaves (int8 codes, packed int4 codes, fp32
scales) keep their dtypes and bits.  ``adapter_from_jax`` carries a LoRA
adapter the same way.  Only numpy crosses the boundary, so this module
imports no JAX.
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


def adapter_from_jax(adapter_np, device=None):
    """A JAX ``LoRAAdapter``'s hyperparameters and factors as numpy (an
    object with ``rank``, ``alpha``, ``targets`` and ``factors`` of
    ``{target: {"a", "b"}}`` arrays, or the same keys in a dict) → the
    port's ``ops.lora.LoRAAdapter`` with fp32 tensors on ``device``
    (default ``cuda``)."""
    from .ops.lora import LoRAAdapter

    get = (adapter_np.get if isinstance(adapter_np, dict)
           else lambda k: getattr(adapter_np, k))
    factors = params_from_jax(
        {t: {k: np.asarray(v[k], np.float32) for k in ("a", "b")}
         for t, v in get("factors").items()}, device)
    return LoRAAdapter(rank=int(get("rank")), alpha=float(get("alpha")),
                       targets=tuple(get("targets")), factors=factors)
