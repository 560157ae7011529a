"""The port's sampling functions against the JAX package's, on the CPU.

The filters see the same logits (numpy, from a seed, with ties at the
k-th value) and must keep the same tokens, bit for bit.  The random
draw cannot match ``jax.random.categorical``; it is held to its
invariants: a seed names one draw, and a draw stays in the filtered
support.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.generation import sampling as jsampling
from megatron_llm_tpu_torch.generation.sampling import (
    NEG_INF,
    modify_logits_for_top_k_filtering,
    modify_logits_for_top_p_filtering,
    sample,
    stream_seed,
)
from megatron_llm_tpu_torch.serving import engine as tengine

torch.set_num_threads(1)


def _kept(out):
    return (np.asarray(out) > NEG_INF / 2).tolist()


def test_top_k_filtering_keeps_k():
    logits = torch.tensor([[1.0, 5.0, 3.0, 2.0, 4.0]])
    out = modify_logits_for_top_k_filtering(logits, 2)
    assert _kept(out[0]) == [False, True, False, False, True]


def test_top_k_zero_is_identity():
    logits = torch.tensor([[1.0, 2.0]])
    assert torch.equal(modify_logits_for_top_k_filtering(logits, 0), logits)


def test_top_p_keeps_nucleus():
    # probs ~ [0.64, 0.24, 0.09, 0.03]: top_p=0.7 keeps the first two
    logits = torch.log(torch.tensor([[0.64, 0.24, 0.09, 0.03]]))
    out = modify_logits_for_top_p_filtering(logits, 0.7)
    assert _kept(out[0]) == [True, True, False, False]


def test_top_p_always_keeps_argmax():
    logits = torch.log(torch.tensor([[0.97, 0.01, 0.01, 0.01]]))
    out = modify_logits_for_top_p_filtering(logits, 0.5)
    assert _kept(out[0]) == [True, False, False, False]


def test_greedy_when_no_filters():
    logits = torch.tensor([[0.1, 9.0, 0.2], [3.0, 1.0, 2.0]])
    out = sample(logits, None, top_k=0, top_p=0.0, temperature=0.5)
    assert out.tolist() == [1, 0]


def test_vocab_clamp_masks_padding():
    # padded vocab 8, real vocab 5: padding ids must never be sampled
    logits = torch.zeros((4, 8))
    logits[:, 6] = 100.0
    out = sample(logits, (0, 0), top_k=3, vocab_size=5)
    assert bool((out < 5).all())


def test_top_k_sampling_stays_in_top_k():
    logits = torch.tensor(np.random.default_rng(0).normal(size=(16, 32)),
                          dtype=torch.float32)
    top4 = np.argsort(logits.numpy(), axis=-1)[:, -4:]
    for step in range(8):
        out = sample(logits, (1, step), top_k=4)
        for i, t in enumerate(out.tolist()):
            assert t in top4[i]


def test_both_topk_topp_rejected():
    with pytest.raises(AssertionError):
        sample(torch.zeros((1, 4)), (0, 0), top_k=2, top_p=0.5)


def _tied_logits(seed):
    """Random logits rounded to a coarse grid, so values repeat and the
    k-th largest is often tied."""
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(size=(6, 40)) * 2) / 2


@pytest.mark.parametrize("top_k", [1, 3, 7, 40])
def test_top_k_filter_matches_jax(top_k):
    x = _tied_logits(top_k).astype(np.float32)
    want = jsampling.modify_logits_for_top_k_filtering(jnp.asarray(x), top_k)
    got = modify_logits_for_top_k_filtering(torch.tensor(x), top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9, 0.999])
def test_top_p_filter_matches_jax(top_p):
    x = (np.random.default_rng(3).normal(size=(6, 40)) * 3).astype(
        np.float32)
    want = jsampling.modify_logits_for_top_p_filtering(jnp.asarray(x), top_p)
    got = modify_logits_for_top_p_filtering(torch.tensor(x), top_p)
    assert _kept(got) == _kept(want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_matches_jax_with_padding():
    x = np.random.default_rng(4).normal(size=(8, 24)).astype(np.float32)
    x[:, 20:] += 10.0  # padded columns would win without the mask
    want = jsampling.sample(jnp.asarray(x), None, vocab_size=20)
    got = sample(torch.tensor(x), None, vocab_size=20)
    assert got.tolist() == np.asarray(want).tolist()


def test_top_p_sampling_stays_in_nucleus():
    x = torch.tensor(np.random.default_rng(5).normal(size=(16, 32)) * 2,
                     dtype=torch.float32)
    kept = np.asarray(_kept(modify_logits_for_top_p_filtering(x / 0.7, 0.6)))
    for step in range(8):
        out = sample(x, (2, step), top_p=0.6, temperature=0.7)
        for i, t in enumerate(out.tolist()):
            assert kept[i, t]


def test_a_seed_names_one_draw():
    x = torch.zeros((4, 64))
    a = sample(x, (7, 3), top_k=64)
    assert torch.equal(a, sample(x, (7, 3), top_k=64))
    # an explicit generator draws the stream the pair names
    gen = torch.Generator().manual_seed(stream_seed(7, 3))
    assert torch.equal(a, sample(x, gen, top_k=64))
    draws = {tuple(sample(x, (7, s), top_k=64).tolist()) for s in range(6)}
    assert len(draws) > 1


def test_engine_draws_from_the_same_streams():
    """The engine's per-slot draw keeps its bits: a sampled slot is the
    Gumbel-max draw of the stream ``stream_seed(seed, counter)``."""
    x = torch.tensor(np.random.default_rng(6).normal(size=(2, 32)),
                     dtype=torch.float32)
    tok, _ = tengine._sample_slots(x, [5, 9], [3, 4], [False, False],
                                   [1.0, 1.0], [0, 0], [0.0, 0.0], 32)
    for i, (seed, counter) in enumerate(((5, 3), (9, 4))):
        gen = torch.Generator().manual_seed(stream_seed(seed, counter))
        u = torch.rand(32, generator=gen)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        assert int(tok[i]) == int(torch.argmax(x[i] + gumbel))
    assert tengine.NEG_INF == NEG_INF == jsampling.NEG_INF
