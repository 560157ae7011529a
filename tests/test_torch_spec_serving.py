"""Fused decode and n-gram speculative decoding in the port's serving path,
against the JAX package's, on the CPU.

Config: Llama-style, hidden 256, head dim 128 (2 heads), 2 layers, ffn
512, vocab 128, fp32, with JAX's random weights carried across.  At the
default ``fused_decode=True`` the port's engine decodes through the fused
kernels' plain versions (K13; K14 for verify steps) while JAX's, off a
TPU, takes its composed route: greedy tokens must be the same.  Prompts
repeat spans so that the n-gram drafter proposes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu.serving import engine as jengine
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation.server import GenerationService
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving import engine as tengine
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

# fp32 logits through two layers on both sides; sums in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SLICE = dict(max_batch_size=2, max_seq_len=128, kv_block_size=16,
             prefill_bucket=8, prefix_cache_blocks=0, trace=False)
NEW = (12, 9, 14, 10)


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=2, num_attention_heads=2,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=128, max_position_embeddings=128,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def weights():
    jc = jllama2("7b", **_kw())
    jp = jmodel.init_params(jax.random.key(0), jc)
    return jc, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts():
    """Prompts that repeat a span, so the trailing n-gram has an earlier
    occurrence and the drafter proposes."""
    rng = np.random.default_rng(0)
    out = []
    for n in (6, 9, 5, 8):
        span = rng.integers(1, 120, n).tolist()
        out.append(span + rng.integers(1, 120, 3).tolist() + span)
    return out


def _run(engine, force=()):
    engine.start()
    try:
        hs = [engine.submit(p, n, use_eos_stop=False, spec_force=i in force)
              for i, (p, n) in enumerate(zip(_prompts(), NEW))]
        return [h.result(timeout=300).tokens for h in hs], \
            engine.metrics.snapshot()
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_tokens(weights):
    jc, jp, _ = weights
    import dataclasses

    engine = JServingEngine(dataclasses.replace(jc, fused_decode=False), jp,
                            JEngineConfig(**SLICE))
    engine.start()
    try:
        hs = [engine.submit(p, n, use_eos_stop=False)
              for p, n in zip(_prompts(), NEW)]
        return [h.result(timeout=300).tokens for h in hs]
    finally:
        engine.shutdown()


def _port(weights, fused=True, **kw):
    tc = tllama2("7b", **_kw(fused_decode=fused))
    return ServingEngine(tc, weights[2], EngineConfig(**{**SLICE, **kw}),
                         device="cpu")


def test_fused_engine_matches_jax(weights, jax_tokens):
    """The default ``fused_decode=True`` engine decodes through K13 (its
    plain version): JAX's tokens, every step counted as fused."""
    engine = _port(weights)
    got, m = _run(engine)
    assert engine._fused_decode and not engine._fused_verify
    assert got == jax_tokens
    routes = m["step_routes"]["fp32"]
    assert routes["fallback"] == 0
    # (a pipelined step dispatched after its slots all retired is counted
    # but never processed)
    assert routes["fused"] >= m["decode_iterations"] > 0
    assert m["spec_steps"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["k14", "composed"])
def test_spec_engine_matches_jax_and_spec_off(weights, jax_tokens, fused):
    """``spec_draft_len=3``: verify steps run (K14's plain version on the
    fused route, W composed steps otherwise) and the greedy tokens are
    the JAX engine's, i.e. those of the port with speculation off."""
    engine = _port(weights, fused=fused, spec_draft_len=3)
    got, m = _run(engine)
    assert engine._fused_verify == fused
    assert got == jax_tokens
    assert m["spec_steps"] > 0 and m["spec_proposed"] > 0
    assert m["spec_by_source"]["ngram"]["steps"] == m["spec_steps"]
    routes = m["step_routes"]["fp32"]
    # every iteration (plain or verify) is counted on its route
    assert routes["fused" if fused else "fallback"] \
        >= m["decode_iterations"] > m["spec_steps"]
    assert routes["fallback" if fused else "fused"] == 0
    assert 0.0 <= m["spec_acceptance_rate"] <= 1.0
    assert m["accepted_tokens_per_step"]["total_count"] > 0


def test_spec_force_is_lossless(weights, jax_tokens):
    """``spec_force`` drafts without an n-gram match (repeating the last
    token): mostly rejected, never changing the tokens."""
    engine = _port(weights, spec_draft_len=3)
    got, m = _run(engine, force=(0, 2))
    assert got == jax_tokens
    assert m["spec_steps"] > 0


def test_generation_service_plumbs_spec(weights):
    tc = tllama2("7b", **_kw())
    svc = GenerationService(tc, weights[2], NullTokenizer(127),
                            max_batch_size=2, engine_max_seq_len=64,
                            prefix_cache_blocks=0, kv_block_size=16,
                            spec_draft_len=3, spec_ngram=2, trace=False,
                            device="cpu")
    try:
        ec = svc.engine.config
        assert (ec.spec_draft_len, ec.spec_ngram) == (3, 2)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# The drafter
# ---------------------------------------------------------------------------


def _contexts():
    rng = np.random.default_rng(1)
    ctx = [rng.integers(0, 5, 40).tolist() for _ in range(4)]
    span = rng.integers(0, 1000, 7).tolist()
    ctx += [span + [3, 4] + span, span * 3, [1, 2, 3], [], [9] * 10]
    return ctx


@pytest.mark.parametrize("i", range(9))
@pytest.mark.parametrize("ngram,k", [(3, 3), (2, 5), (1, 1)])
def test_ngram_draft_matches_jax(i, ngram, k):
    ctx = _contexts()[i]
    assert tengine._ngram_draft_host(ctx, ngram, k) \
        == jengine._ngram_draft_host(ctx, ngram, k)


# ---------------------------------------------------------------------------
# forward_cached_paged_verify against JAX's composed arm
# ---------------------------------------------------------------------------

BLOCK, T = 16, 8


def _verify_inputs(form):
    import dataclasses

    jc = jllama2("7b", **_kw(kv_cache_quant=form))
    tc = tllama2("7b", **_kw(kv_cache_quant=form))
    jp = jmodel.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(2)
    S, W = 3, 4
    fills = np.asarray([37, 16, 0], np.int32)
    tables = (rng.permutation(S * T) + 1).reshape(S, T).astype(np.int32)
    shape = (2, 1 + S * T, 2, BLOCK, 128)
    if form == "int8":
        leaves = [{"q": rng.integers(-127, 128, shape).astype(np.int8),
                   "scale": rng.uniform(0.002, 0.012, shape[:-1]).astype(
                       np.float32)} for _ in range(2)]
    else:
        leaves = [rng.normal(size=shape).astype(np.float32)
                  for _ in range(2)]
    window = rng.integers(0, 128, (S, W)).astype(np.int32)
    pos = fills[:, None] + np.arange(W)[None, :]
    bids = np.take_along_axis(tables, pos // BLOCK, 1).reshape(-1)
    offs = (pos % BLOCK).reshape(-1)
    del dataclasses
    return jc, tc, jp, tp, leaves, window, tables, fills, bids, offs


def _as(leaf, mod):
    if isinstance(leaf, dict):
        return {k: _as(v, mod) for k, v in leaf.items()}
    return jnp.asarray(leaf) if mod == "jax" else torch.from_numpy(
        leaf.copy())


@pytest.mark.parametrize("form", ["none", "int8"])
@pytest.mark.parametrize("fused", [True, False], ids=["k14", "composed"])
def test_verify_matches_jax_composed(form, fused):
    jc, tc, jp, tp, leaves, window, tables, fills, bids, offs = \
        _verify_inputs(form)
    want, wk, wv = jmodel.forward_cached_paged_verify(
        jc, jp, jnp.asarray(window), _as(leaves[0], "jax"),
        _as(leaves[1], "jax"), jnp.asarray(tables), jnp.asarray(fills),
        jnp.asarray(bids), jnp.asarray(offs), use_fused=False)
    tk, tv = _as(leaves[0], "torch"), _as(leaves[1], "torch")
    got, gk, gv = tmodel.forward_cached_paged_verify(
        tc, tp, torch.from_numpy(window).long(), tk, tv,
        torch.from_numpy(tables), torch.from_numpy(fills),
        torch.from_numpy(bids), torch.from_numpy(offs), use_fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for g, w in ((gk, wk), (gv, wv)):
        if form == "int8":
            g = (g["q"].float() * g["scale"][..., None]).numpy()
            w = np.asarray(w["q"], np.float32) * np.asarray(
                w["scale"])[..., None]
            # a row's codes may flip by one next to a rounding boundary
            np.testing.assert_allclose(g, w, rtol=0, atol=0.02)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **LOGIT_TOL)


def test_verify_arms_agree_on_the_port():
    """K14's plain version and the composed arm give the same logits."""
    _, tc, _, tp, leaves, window, tables, fills, bids, offs = \
        _verify_inputs("none")
    outs = []
    for fused in (True, False):
        outs.append(tmodel.forward_cached_paged_verify(
            tc, tp, torch.from_numpy(window).long(),
            _as(leaves[0], "torch"), _as(leaves[1], "torch"),
            torch.from_numpy(tables), torch.from_numpy(fills),
            torch.from_numpy(bids), torch.from_numpy(offs),
            use_fused=fused)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **LOGIT_TOL)


def test_window_past_the_rope_table_stays_in_bounds():
    """A window whose last rows sit past the RoPE table (positions 126 ..
    129 of a 128-row table) runs; the rows inside the table equal the
    sequential fused steps (to fp32 reassociation: the final norm and
    unembedding run over [S, W] rows against [S, 1])."""
    _, tc, _, tp, leaves, _, tables, _, _, _ = _verify_inputs("none")
    tables = torch.from_numpy(tables)
    fills = torch.tensor([126, 10, 0])
    window = torch.randint(0, 128, (3, 4), generator=torch.Generator()
                           .manual_seed(0))
    pos = fills[:, None] + torch.arange(4)[None, :]
    bids = torch.gather(tables, 1, (pos // BLOCK).clamp(max=T - 1)) \
        .reshape(-1)
    offs = (pos % BLOCK).reshape(-1)
    kp, vp = _as(leaves[0], "torch"), _as(leaves[1], "torch")
    logits, _, _ = tmodel.forward_cached_paged_verify(
        tc, tp, window, kp.clone(), vp.clone(), tables, fills, bids, offs,
        use_fused=True)
    assert torch.isfinite(logits).all()
    k2, v2 = kp.clone(), vp.clone()
    for j in range(2):   # slot 0's positions 126, 127 are in the table
        lj, _, _ = tmodel.forward_cached_paged(
            tc, tp, window[:, j:j + 1], k2, v2, tables, fills + j,
            use_fused=True)
        np.testing.assert_allclose(lj[0, 0].numpy(), logits[0, j].numpy(),
                                   rtol=1e-5, atol=1e-5)
