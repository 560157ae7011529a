"""Token sampling: greedy, temperature, top-k, top-p (nucleus) (mirror of
``megatron_llm_tpu/generation/sampling.py``).

Pure functions over ``[batch, vocab]`` fp32 logits with the JAX
package's semantics: the top-k threshold form (every logit tied with the
k-th largest is kept), the right-shifted nucleus cumsum (the argmax is
always kept), padded-vocab masking, and greedy when ``top_k == 0`` and
``top_p == 0`` (temperature ignored).

The random draw cannot match ``jax.random.categorical`` draw for draw.
It is a Gumbel-max draw from a ``torch.Generator`` on the logits' device:
either one the caller passes, or one seeded from a ``(seed, step)`` pair
by ``stream_seed`` (the serving engine's scheme, so a seed and a token
index name one draw).  The global RNG is never used.
"""

from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1.0e10

# a torch.Generator on the logits' device, or a (seed, step) pair
Rng = Union[torch.Generator, tuple]


def stream_seed(seed: int, counter: int) -> int:
    """The seed of a random stream's ``counter``-th draw (the port's
    ``fold_in(key(seed), counter)``): a splitmix64 hash of both, so every
    bit of the result depends on both (the CPU generator keeps only the
    low 32 bits of its seed)."""
    mask = (1 << 64) - 1
    z = ((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF)
    z = (z + 0x9E3779B97F4A7C15) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1  # a non-negative int64


def generator(rng: Rng, device) -> torch.Generator:
    """``rng`` as a generator on ``device``: a ``(seed, step)`` pair seeds a
    new one with ``stream_seed``."""
    if isinstance(rng, torch.Generator):
        return rng
    seed, step = rng
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, step))
    return gen


def gumbel_argmax(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` ``[b, V]`` by Gumbel-max
    (the engine's draw: uniforms clamped away from 0 and 1)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


def modify_logits_for_top_k_filtering(logits: torch.Tensor,
                                      top_k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to ``NEG_INF``; logits
    equal to the k-th are kept, as JAX's threshold keeps them."""
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def _top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filter core (no guards on ``top_p``)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # shift right: always keep the argmax token
    remove_sorted = (cum - sorted_probs) > top_p
    # threshold logit = smallest kept logit in sorted order
    kept = sorted_logits.masked_fill(remove_sorted, float("inf"))
    threshold = kept.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < threshold, NEG_INF)


def modify_logits_for_top_p_filtering(logits: torch.Tensor,
                                      top_p: float) -> torch.Tensor:
    """Drop tokens outside the smallest set whose cumulative probability
    exceeds ``top_p`` (the first token above the threshold is kept)."""
    if top_p <= 0.0 or top_p >= 1.0:
        return logits
    return _top_p_filter(logits, top_p)


def sample(logits: torch.Tensor, rng: Rng | None = None, *, top_k: int = 0,
           top_p: float = 0.0, temperature: float = 1.0,
           vocab_size: int | None = None) -> torch.Tensor:
    """One token id per row (``[b]`` int64).  ``vocab_size`` masks the
    padded-vocab logits; ``top_k == 0 and top_p == 0`` is greedy."""
    assert not (top_k > 0 and top_p > 0.0), \
        "cannot have both greedy-limiting top-k and top-p (reference :57)"
    if top_k == 0 and top_p == 0.0:
        mode = "greedy"
    elif top_k > 0:
        mode = "top_k"
    else:
        mode = "top_p"
    return sample_with_mode(logits, rng, mode=mode, top_k=top_k, top_p=top_p,
                            temperature=temperature, vocab_size=vocab_size)


def sample_with_mode(logits: torch.Tensor, rng: Rng | None, *, mode: str,
                     top_k: int = 0, top_p=0.0, temperature=1.0,
                     vocab_size: int | None = None) -> torch.Tensor:
    """Sampling core, ``mode`` one of ``"greedy"``, ``"top_k"``,
    ``"top_p"``."""
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= vocab_size
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    if mode == "greedy":
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if mode == "top_k":
        logits = modify_logits_for_top_k_filtering(logits, top_k)
    else:
        logits = _top_p_filter(logits, top_p)
    assert rng is not None, "stochastic sampling requires an rng"
    return gumbel_argmax(logits, generator(rng, logits.device))
