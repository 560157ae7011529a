"""The port's prompt-lookup speculation (``generate_tokens_pld``) against
the JAX package's, and against the port's own greedy ``generate_tokens``,
on the CPU.

fp32 configs with JAX's random weights carried across: the JAX tests'
tiny Llama (head dim 16, the composed route everywhere) and a Llama-style
model of head dim 128 whose tail steps take the fused decode kernel's
plain version (K12).  Tokens, lengths and the verify-step count must be
JAX's, and the tokens the port's greedy loop's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import gpt_config as jgpt
from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation.speculative import \
    generate_tokens_pld as jpld
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu_torch.config import gpt_config as tgpt
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation.generation import generate_tokens
from megatron_llm_tpu_torch.generation.speculative import (
    _ngram_draft,
    generate_tokens_pld,
)

torch.set_num_threads(1)


def _weights(jc, tc, seed=0):
    jp = jm.init_params(jax.random.key(seed), jc)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module", params=["tiny", "fused"])
def setup(request):
    if request.param == "tiny":
        kw = dict(params_dtype="float32", seq_length=128,
                  max_position_embeddings=128)
        return _weights(jtiny(**kw), ttiny(**kw))
    kw = dict(hidden_size=256, num_layers=2, num_attention_heads=2,
              num_kv_heads=2, ffn_hidden_size=512, vocab_size=256,
              make_vocab_size_divisible_by=8, seq_length=128,
              max_position_embeddings=128, params_dtype="float32",
              attention_impl="dot")
    return _weights(jllama2("7b", **kw), tllama2("7b", **kw))


def _prompts(cfg, lengths, total, seed=0, period=None):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), total), np.int32)
    for i, n in enumerate(lengths):
        if period is not None and i == 0:
            span = rng.integers(3, cfg.vocab_size, period)
            toks[i, :n] = np.tile(span, n // period + 1)[:n]
        else:
            toks[i, :n] = rng.integers(3, cfg.vocab_size, n)
    return toks, np.asarray(lengths, np.int32)


def _check(setup, toks, lens, **kw):
    """PLD's tokens, lengths and steps equal JAX's PLD; its tokens up to
    each length equal the port's greedy loop's.  Returns the port's."""
    jc, jp, tc, tp = setup
    want = jpld(jc, jp, jnp.asarray(toks), jnp.asarray(lens), **kw)
    got = generate_tokens_pld(tc, tp, toks, lens, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert got.steps == int(want.steps)
    eos_kw = {n: kw[n] for n in ("eos_id", "use_eos_stop") if n in kw}
    plain = generate_tokens(tc, tp, toks, lens, **eos_kw)
    np.testing.assert_array_equal(got.lengths.numpy(), plain.lengths.numpy())
    for i, n in enumerate(plain.lengths.tolist()):
        assert got.tokens[i, :n].tolist() == plain.tokens[i, :n].tolist()
    return got


@pytest.mark.parametrize("b,draft_len,ngram", [(1, 5, 3), (3, 4, 2),
                                               (2, 7, 3)])
def test_pld_matches_jax_and_plain_greedy(setup, b, draft_len, ngram):
    toks, lens = _prompts(setup[2], (16,) * b, 96)
    got = _check(setup, toks, lens, draft_len=draft_len, ngram=ngram,
                 use_eos_stop=False)
    assert got.steps <= 96 - 16 + 1


def test_pld_accelerates_repetitive_continuation(setup):
    toks, lens = _prompts(setup[2], (24,), 120, seed=7, period=6)
    got = _check(setup, toks, lens, draft_len=6, ngram=3,
                 use_eos_stop=False)
    out = got.tokens[0, 24:].numpy()
    if (out[6:] == out[:-6]).mean() > 0.9:  # the model cycles
        assert got.steps < (120 - 24) // 2
    # every committed token past one a verify step is an accepted draft
    # token; the tail's steps commit one each
    assert 0 <= got.accepted <= got.proposed
    assert got.proposed % 6 == 0
    assert (120 - 24) == got.steps + got.accepted


def test_pld_eos_stop(setup):
    """EOS inside an accepted window ends that row at the right length
    (EOS set to a token the greedy continuation emits)."""
    jc, jp, tc, tp = setup
    toks, lens = _prompts(tc, (16, 16), 80, seed=3)
    plain = generate_tokens(tc, tp, toks, lens, use_eos_stop=False)
    eos = int(plain.tokens[0, 24])
    got = _check(setup, toks, lens, eos_id=eos, draft_len=4, ngram=2,
                 use_eos_stop=True)
    assert int(got.lengths[0]) <= 25


def test_pld_ragged_prompts(setup):
    toks, lens = _prompts(setup[2], (16, 23, 40), 96, seed=11)
    _check(setup, toks, lens, draft_len=5, ngram=3, use_eos_stop=False)


def test_pld_ragged_with_eos(setup):
    jc, jp, tc, tp = setup
    toks, lens = _prompts(tc, (12, 31), 80, seed=13)
    plain = generate_tokens(tc, tp, toks, lens, use_eos_stop=False)
    eos = int(plain.tokens[1, 40])
    _check(setup, toks, lens, eos_id=eos, draft_len=4, ngram=2,
           use_eos_stop=True)


def test_pld_per_sample_acceptance_not_lockstep(setup):
    """A periodic row batched with an incompressible one advances by its
    own acceptance."""
    toks, lens = _prompts(setup[2], (24, 24), 120, seed=17, period=6)
    got = _check(setup, toks, lens, draft_len=6, ngram=3,
                 use_eos_stop=False)
    assert got.steps <= 120 - 24 + 1


def test_pld_composes_with_int8_cache(setup):
    jc, jp, tc, tp = setup
    q = (dataclasses.replace(jc, kv_cache_quant="int8").validate(), jp,
         dataclasses.replace(tc, kv_cache_quant="int8").validate(), tp)
    toks, lens = _prompts(tc, (16, 16), 64, seed=5)
    _check(q, toks, lens, draft_len=4, ngram=2, use_eos_stop=False)


def test_pld_never_emits_padded_vocab_ids():
    kw = dict(params_dtype="float32", vocab_size=250,
              make_vocab_size_divisible_by=64, seq_length=96,
              max_position_embeddings=96)
    setup = _weights(jtiny(**kw), ttiny(**kw), seed=4)
    assert setup[2].padded_vocab_size() > setup[2].vocab_size
    toks, lens = _prompts(setup[2], (16, 16), 96, seed=9)
    got = _check(setup, toks, lens, use_eos_stop=False)
    assert int(got.tokens.max()) < 250


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_pld_at_the_end_of_the_position_tables(family):
    """A buffer as long as the position tables: rows that run out of room
    ride the verify forward with positions past the tables (JAX's gather
    clamps them); the port clamps them too, so it runs and equals JAX,
    the out-of-room rows' tail steps included.  GPT's learned position
    table and the rope table alike."""
    if family == "gpt":
        kw = dict(hidden_size=64, num_layers=2, num_attention_heads=4,
                  vocab_size=128, make_vocab_size_divisible_by=8,
                  seq_length=64, max_position_embeddings=64,
                  params_dtype="float32")
        setup = _weights(jgpt("125m", **kw), tgpt("125m", **kw), seed=6)
    else:
        kw = dict(params_dtype="float32", seq_length=64,
                  max_position_embeddings=64)
        setup = _weights(jtiny(**kw), ttiny(**kw), seed=6)
    toks, lens = _prompts(setup[2], (40, 45, 52), 64, seed=21, period=4)
    got = _check(setup, toks, lens, draft_len=5, ngram=2,
                 use_eos_stop=False)
    assert got.lengths.tolist() == [64, 64, 64]


def test_ngram_draft_picks_the_latest_match():
    toks = torch.tensor([[5, 6, 7, 1, 5, 6, 8, 2, 5, 6, 0, 0],
                         [9, 9, 9, 9, 0, 0, 0, 0, 0, 0, 0, 0]])
    cur = torch.tensor([9, 4])
    t0 = torch.tensor([6, 4])
    draft = _ngram_draft(toks, cur, t0, ngram=2, draft_len=3)
    # row 0's key (5, 6) last occurred at 4: the draft is what followed
    assert draft[0].tolist() == [8, 2, 5]
    # row 1's key (9, 4) never occurred: the draft repeats t0
    assert draft[1].tolist() == [4, 4, 4]
