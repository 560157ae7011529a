"""The port's KV-cached generation (``generate_tokens``, ``score_tokens``,
``beam_search``) against the JAX package's, on the CPU.

Two fp32 configs, JAX's random weights carried across with
``params_from_jax``, prompts from a numpy seed:

- ``tiny``: the JAX tests' tiny Llama (head dim 16), which takes the
  composed route on both sides;
- ``fused``: Llama-style, hidden 256, head dim 128, which the port's
  single-token steps take through the fused decode kernel's plain version
  (K12) at ``fused_decode=True``, and through the composed route at
  ``False``; JAX's, off a TPU, is composed either way.

Tokens and lengths must be identical; log-probs and beam scores within
1e-4 (fp32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation import beam_search as jbeam
from megatron_llm_tpu.generation import generate_tokens as jgenerate
from megatron_llm_tpu.generation import score_tokens as jscore
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import (
    beam_search,
    generate_tokens,
    score_tokens,
)
from megatron_llm_tpu_torch.kernels import decode_step as tds
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
_FUSED = dict(hidden_size=256, num_layers=2, num_attention_heads=2,
              num_kv_heads=2, ffn_hidden_size=512, vocab_size=120,
              make_vocab_size_divisible_by=64, seq_length=128,
              max_position_embeddings=128, params_dtype="float32",
              attention_impl="dot")


def _pair(name, **kw):
    if name == "tiny":
        base = dict(num_layers=2, vocab_size=64,
                    make_vocab_size_divisible_by=8)
        base.update(kw)
        return jtiny(**base), ttiny(**base)
    base = dict(_FUSED)
    base.update(kw)
    return jllama2("7b", **base), tllama2("7b", **base)


@pytest.fixture(scope="module", params=["tiny", "fused", "fused_off"])
def model(request):
    """(JAX cfg, JAX params, port cfg, port params) for each route."""
    name = request.param
    jc, tc = _pair("tiny" if name == "tiny" else "fused",
                   fused_decode=name != "fused_off")
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    if name == "fused":
        k, _ = tm.init_kv_cache(tc, 2, 8, device="cpu")
        assert tds.fused_decode_eligible(tc, tp, k, 1)
    return jc, jp, tc, tp


def _prompts(cfg, lengths, total, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), total), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return toks, np.asarray(lengths, np.int32)


def _assert_same(got, want, logprobs=False):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    if logprobs:
        np.testing.assert_allclose(got.logprobs.numpy(),
                                   np.asarray(want.logprobs), **TOL)


def test_cached_decode_matches_full_forward(model):
    """Prefill 5 then single-token steps reproduce the full forward's
    logits, the port's and JAX's."""
    jc, jp, tc, tp = model
    toks, _ = _prompts(tc, (12, 12), 12, 0)
    full = np.asarray(jm.forward(jc, jp, jnp.asarray(toks)))
    t = torch.tensor(toks, dtype=torch.long)
    k, v = tm.init_kv_cache(tc, 2, 12, device="cpu")
    with torch.no_grad():
        lg, k, v = tm.forward_cached(tc, tp, t[:, :5], k, v, 0,
                                     empty_cache=True)
        np.testing.assert_allclose(lg.numpy(), full[:, :5], **TOL)
        for i in range(5, 12):
            lg, k, v = tm.forward_cached(tc, tp, t[:, i:i + 1], k, v, i)
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i], **TOL)


def test_greedy_matches_jax_and_naive_loop(model):
    jc, jp, tc, tp = model
    toks, lens = _prompts(tc, (4,), 10, 1)
    want = jgenerate(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                     eos_id=-1, use_eos_stop=False)
    got = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False)
    _assert_same(got, want)
    # naive loop: repeated full forward + argmax over the real vocab
    cur = toks[0, :4].tolist()
    with torch.no_grad():
        for _ in range(6):
            lg = tm.forward(tc, tp, torch.tensor([cur]))
            cur.append(int(torch.argmax(lg[0, -1, :tc.vocab_size])))
    assert got.tokens[0].tolist() == cur


def test_ragged_prompts_match_jax(model):
    """The longer prompt is teacher-forced while the shorter generates."""
    jc, jp, tc, tp = model
    toks, lens = _prompts(tc, (3, 7, 5), 14, 2)
    want = jgenerate(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                     eos_id=-1, use_eos_stop=False, return_logprobs=True)
    got = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                          return_logprobs=True)
    _assert_same(got, want, logprobs=True)
    for i, n in enumerate(lens):
        assert got.tokens[i, :n].tolist() == toks[i, :n].tolist()


def test_eos_early_stop_matches_jax(model):
    """EOS set to a row's first greedy token: that row stops at prompt + 1
    while the other runs on; with every row stopped the loop ends."""
    jc, jp, tc, tp = model
    toks, lens = _prompts(tc, (3, 6), 16, 3)
    first = jgenerate(jc, jp, jnp.asarray(toks[:1]), jnp.asarray(lens[:1]),
                      eos_id=-1, use_eos_stop=False)
    eos = int(np.asarray(first.tokens)[0, 3])
    want = jgenerate(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                     eos_id=eos)
    got = generate_tokens(tc, tp, toks, lens, eos_id=eos)
    _assert_same(got, want)
    assert int(got.lengths[0]) == 4 and int(got.tokens[0, 3]) == eos
    solo = generate_tokens(tc, tp, toks[:1], lens[:1], eos_id=eos)
    assert solo.lengths.tolist() == [4]


def test_logprobs_match_score_and_jax(model):
    """Generation-time log-probs equal post-hoc scoring of the sequence,
    and both equal JAX's."""
    jc, jp, tc, tp = model
    toks, lens = _prompts(tc, (4,), 9, 4)
    want = jgenerate(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                     eos_id=-1, use_eos_stop=False, return_logprobs=True)
    got = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                          return_logprobs=True)
    _assert_same(got, want, logprobs=True)
    scored = score_tokens(tc, tp, got.tokens)
    np.testing.assert_allclose(got.logprobs.numpy(), scored.numpy(), **TOL)


def test_score_tokens_matches_jax(model):
    jc, jp, tc, tp = model
    toks, _ = _prompts(tc, (11, 11, 11), 11, 5)
    want = jscore(jc, jp, jnp.asarray(toks))
    got = score_tokens(tc, tp, toks)
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [dict(top_k=5, temperature=0.9),
                                dict(top_p=0.8, temperature=1.3)])
def test_sampled_generation_seeded_and_in_support(model, kw):
    """A seed gives the same tokens, another seed other tokens, and every
    sampled token lies in the step's top-k or nucleus (JAX's draws cannot
    be matched one for one)."""
    _, _, tc, tp = model
    toks, lens = _prompts(tc, (2, 2), 12, 6)
    a = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                        seed=42, **kw)
    b = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                        seed=42, **kw)
    c = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                        seed=43, **kw)
    assert torch.equal(a.tokens, b.tokens)
    assert not torch.equal(a.tokens, c.tokens)
    from megatron_llm_tpu_torch.generation import sampling

    with torch.no_grad():
        lg = tm.forward(tc, tp, a.tokens)[..., :tc.vocab_size]
    lg = lg / kw["temperature"]
    for pos in range(2, 12):
        step = lg[:, pos - 1]
        if "top_k" in kw:
            kept = sampling.modify_logits_for_top_k_filtering(step,
                                                              kw["top_k"])
        else:
            kept = sampling.modify_logits_for_top_p_filtering(step,
                                                              kw["top_p"])
        for i in range(2):
            assert kept[i, a.tokens[i, pos]] > sampling.NEG_INF / 2


def test_generation_errors_match_jax(model):
    _, _, tc, tp = model
    toks, lens = _prompts(tc, (6,), 6, 7)
    with pytest.raises(ValueError, match="context length"):
        generate_tokens(tc, tp, toks, lens)
    with pytest.raises(ValueError, match="context length"):
        beam_search(tc, tp, toks[0], 6, beam_size=2)
    with pytest.raises(AssertionError):
        generate_tokens(tc, tp, np.pad(toks, ((0, 0), (0, 2))), lens,
                        top_k=2, top_p=0.5)


def test_beam_size_1_matches_greedy(model):
    jc, jp, tc, tp = model
    toks, lens = _prompts(tc, (4,), 10, 8)
    beam = beam_search(tc, tp, toks[0], 4, beam_size=1, stop_token=-1)
    greedy = generate_tokens(tc, tp, toks, lens, eos_id=-1,
                             use_eos_stop=False)
    assert beam.tokens[0].tolist() == greedy.tokens[0].tolist()
    want = jbeam(jc, jp, jnp.asarray(toks[0]), 4, beam_size=1,
                 stop_token=-1)
    np.testing.assert_allclose(beam.scores.numpy(), np.asarray(want.scores),
                               **TOL)


@pytest.mark.parametrize("width,penalty,total", [(3, 1.0, 12), (4, 1.0, 13),
                                                 (4, 0.5, 11)])
def test_beam_search_matches_jax(model, width, penalty, total):
    """Widths 3 and 4: every returned hypothesis, its length and score
    equal JAX's (a wrong KV reorder passes width 1 and fails here)."""
    jc, jp, tc, tp = model
    toks, _ = _prompts(tc, (4,), total, 9 + width)
    want = jbeam(jc, jp, jnp.asarray(toks[0]), 4, beam_size=width,
                 stop_token=-1, num_return_gen=width,
                 length_penalty=penalty)
    got = beam_search(tc, tp, toks[0], 4, beam_size=width, stop_token=-1,
                      num_return_gen=width, length_penalty=penalty)
    _assert_same(got, want)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)
    assert bool((got.scores[1:] <= got.scores[:-1]).all())  # descending


def test_beam_search_stop_hypotheses_match_jax(model):
    """A stop token that the beams meet: finished hypotheses (recorded
    without the stop token, at length cur) merge with the open beams as
    JAX merges them, the early-exit test included."""
    jc, jp, tc, tp = model
    toks, _ = _prompts(tc, (3,), 12, 20)
    first = jgenerate(jc, jp, jnp.asarray(toks[None, 0]),
                      jnp.asarray([3], jnp.int32), eos_id=-1,
                      use_eos_stop=False)
    seen = np.asarray(first.tokens)[0, 3:6].tolist()
    for stop, penalty in ((seen[0], 0.0), (seen[1], 1.0), (seen[2], 2.0)):
        want = jbeam(jc, jp, jnp.asarray(toks[0]), 3, beam_size=3,
                     stop_token=stop, num_return_gen=3,
                     length_penalty=penalty)
        got = beam_search(tc, tp, toks[0], 3, beam_size=3, stop_token=stop,
                          num_return_gen=3, length_penalty=penalty)
        _assert_same(got, want)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), **TOL)
    # length_penalty 0: the 1-token finished hypothesis (the greedy stop)
    # beats every open beam, and excludes the stop token
    got = beam_search(tc, tp, toks[0], 3, beam_size=2, stop_token=seen[0],
                      num_return_gen=2, length_penalty=0.0)
    assert int(got.lengths[0]) == 3


def _int8(model):
    jc, jp, tc, tp = model
    return (dataclasses.replace(jc, kv_cache_quant="int8").validate(), jp,
            dataclasses.replace(tc, kv_cache_quant="int8").validate(), tp)


def test_int8_cache_generation_matches_jax(model):
    """An int8 KV cache: greedy and ragged tokens, log-probs, and a width-3
    beam (its reorder moves both the codes and the scales) equal JAX's."""
    jc, jp, tc, tp = _int8(model)
    toks, lens = _prompts(tc, (3, 6), 12, 30)
    want = jgenerate(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                     eos_id=-1, use_eos_stop=False, return_logprobs=True)
    got = generate_tokens(tc, tp, toks, lens, eos_id=-1, use_eos_stop=False,
                          return_logprobs=True)
    _assert_same(got, want, logprobs=True)
    want = jbeam(jc, jp, jnp.asarray(toks[1]), 6, beam_size=3,
                 stop_token=-1, num_return_gen=3)
    got = beam_search(tc, tp, toks[1], 6, beam_size=3, stop_token=-1,
                      num_return_gen=3)
    _assert_same(got, want)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)


def test_cache_take_rows_copies_every_leaf():
    """The beam reorder returns new tensors: writing the result leaves the
    source alone, and a row taken twice is two rows."""
    dense = torch.randn(2, 3, 2, 8, 16)
    q = {"q": torch.randint(-127, 128, (2, 3, 2, 8, 16), dtype=torch.int8),
         "scale": torch.rand(2, 3, 2, 8)}
    idx = torch.tensor([2, 2, 0])
    for cache in (dense, q):
        leaves = cache if isinstance(cache, dict) else {"x": cache}
        before = {n: a.clone() for n, a in leaves.items()}
        out = tm.cache_take_rows(cache, idx)
        outs = out if isinstance(out, dict) else {"x": out}
        assert outs.keys() == leaves.keys()
        for n, a in outs.items():
            assert torch.equal(a, before[n].index_select(1, idx))
            a[:, 0] += 1
            assert torch.equal(a[:, 1], before[n][:, 2])
        for n, a in leaves.items():
            assert torch.equal(a, before[n])


def test_engine_greedy_equals_generate_tokens(model):
    """The JAX engine's contract, port against port: the engine's greedy
    tokens for each prompt are the one-shot ``generate_tokens``'."""
    _, _, tc, tp = model
    rng = np.random.default_rng(40)
    prompts = [rng.integers(1, tc.vocab_size, int(n)).tolist()
               for n in (3, 9, 5, 7)]
    engine = ServingEngine(tc, tp, EngineConfig(
        max_batch_size=2, max_seq_len=64, kv_block_size=16,
        prefill_bucket=8, prefix_cache_blocks=0, trace=False), device="cpu")
    engine.start()
    try:
        hs = [engine.submit(p, 8, use_eos_stop=False) for p in prompts]
        got = [h.result(timeout=300).tokens for h in hs]
    finally:
        engine.shutdown()
    for p, toks in zip(prompts, got):
        buf = np.zeros((1, len(p) + 8), np.int32)
        buf[0, :len(p)] = p
        ref = generate_tokens(tc, tp, buf, [len(p)], eos_id=-1,
                              use_eos_stop=False)
        assert toks == ref.tokens[0].tolist()
