"""Dropout and stochastic depth with counter-based masks (the port's
counterpart of ``_dropout``, ``_drop_path`` and ``_layer_rates`` in
``megatron_llm_tpu/models/transformer.py``, and of the ``jax.random`` key
chain that feeds them).

A ``DropoutKey`` is a seed and the path of ``fold_in`` / ``split`` steps
taken from it, the same chain of calls that builds the JAX keys: the
training step folds in the iteration and the microbatch, the model splits
the embedding's key from the stack's, the stack folds in the layer and
each mask its salt.  ``keep_mask`` draws a mask from a fresh
``torch.Generator`` seeded with a hash of the whole key, so a mask depends
on its key alone: recomputing a checkpointed layer (``recompute``
``"selective"`` or ``"full"``) draws exactly the forward's masks, without
leaning on ``torch.utils.checkpoint``'s RNG stashing (which restores only
the default generators).  The bits are not ``jax.random.bernoulli``'s; the
tests that compare with JAX replace ``keep_mask`` with JAX's masks for the
same keys.

A mask does not depend on the layout.  JAX draws each mask for the global
tensor and GSPMD hands each shard its block; here each rank draws the
mask at the global shape (the global microbatch under dp, every head
under tp, the whole sequence under sequence parallelism) and keeps its
block (``slices``), so a sharded run drops what the one-device run drops.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """A seed and its path of ``("fold", data)`` / ``("split", index)``
    steps."""

    seed: int
    path: tuple = ()


def key(seed: int) -> DropoutKey:
    """The root key (``jax.random.key(seed)``)."""
    return DropoutKey(int(seed))


def fold_in(k: DropoutKey, data: int) -> DropoutKey:
    """``jax.random.fold_in(k, data)``."""
    return DropoutKey(k.seed, k.path + (("fold", int(data)),))


def split(k: DropoutKey) -> tuple:
    """The two keys of ``jax.random.split(k)``."""
    return tuple(DropoutKey(k.seed, k.path + (("split", i),))
                 for i in range(2))


def _generator_seed(k: DropoutKey) -> int:
    digest = hashlib.blake2b(repr((k.seed, k.path)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def keep_mask(k: DropoutKey, keep_p: float, shape, device) -> torch.Tensor:
    """Boolean mask of ``shape``, each element True with probability
    ``keep_p``, drawn on ``device`` from the key alone (the one function
    that draws a mask)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(k))
    return torch.rand(tuple(shape), generator=gen, device=device) < keep_p


def _data_slice(shape) -> tuple:
    """The batch block of this rank on the current mesh's dp axis."""
    from ..parallel.mesh import axis_info

    _, dp, index = axis_info("dp")
    if dp == 1:
        return ()
    return ((0, shape[0] * dp, index * shape[0]),)


def block_mask(k: DropoutKey, keep_p: float, shape, device,
               slices=()) -> torch.Tensor:
    """This rank's block ``shape`` of the mask drawn at the global shape:
    ``slices`` holds ``(dim, global size, start)`` of each split dim, and
    the batch dim (0) takes the dp block of the current mesh unless
    ``slices`` names it."""
    slices = tuple(slices)
    if not any(d == 0 for d, _, _ in slices):
        slices = _data_slice(shape) + slices
    if not slices:
        return keep_mask(k, keep_p, shape, device)
    full = list(shape)
    for dim, size, _ in slices:
        full[dim] = size
    mask = keep_mask(k, keep_p, full, device)
    for dim, _, start in slices:
        mask = mask.narrow(dim, start, shape[dim])
    return mask


def _drop(x: torch.Tensor, rate: float, k, shape,
          slices=()) -> torch.Tensor:
    """``x`` scaled by 1 / keep where a ``shape`` mask (broadcast over x)
    keeps it, else 0; the identity without a key or at rate 0."""
    if k is None or rate == 0.0:
        return x
    keep_p = 1.0 - rate
    keep = block_mask(k, keep_p, shape, x.device, slices)
    return torch.where(keep, x / keep_p, 0.0)


def dropout(x: torch.Tensor, rate: float, k, slices=()) -> torch.Tensor:
    """Inverted dropout, one mask element per element of ``x``; ``slices``
    as ``block_mask`` takes them."""
    return _drop(x, rate, k, x.shape, slices)


def drop_path(x: torch.Tensor, rate: float, k) -> torch.Tensor:
    """Stochastic depth: zero the whole residual branch per sample
    (reference DropPath, megatron/model/transformer.py:43-64)."""
    return _drop(x, rate, k, (x.shape[0],) + (1,) * (x.ndim - 1))


def layer_rates(cfg, layer_idx: int) -> tuple:
    """``(hidden_dropout, drop_path)`` rates of layer ``layer_idx``:
    linspace(0, rate, L) as the reference (transformer.py:962-971) for
    LIMA dropout and drop-path, else the flat hidden rate."""
    frac = layer_idx / max(cfg.num_layers - 1, 1)
    hidden = (cfg.hidden_dropout * frac if cfg.lima_dropout
              else cfg.hidden_dropout)
    return hidden, cfg.drop_path_rate * frac
