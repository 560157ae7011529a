"""Speculative decoding with a resident draft model in the port's engine,
against the JAX package's, on the CPU (mirror of the tree-speculation
cases of ``tests/serving/test_sanitize.py``).

Target: Llama-style, hidden 256, head dim 128 (2 heads), 2 layers, ffn
512, vocab 128, fp32, 16-token KV blocks, JAX's random weights carried
across.  At the default ``fused_decode=True`` the port verifies trees
through K14's tree mode (its plain version here) and the JAX engine, off
a TPU, through its composed walk; ``fused_decode=False`` takes the port's
composed walk.  Drafts: ``draft_model("tiny", target)`` (random, a
different model: acceptance near 0) and the target itself (a perfect
draft: every chain token is the target's argmax).  Greedy tokens must be
equal, token for token; the EOS, hedge and ledger cases run the JAX
cases' prompts and budgets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.generation import generate_tokens
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.models.families import draft_model as jdraft_model
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation.server import GenerationService
from megatron_llm_tpu_torch.models.families import draft_model
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving import engine as tengine
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

SLICE = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16,
             idle_wait_s=0.005, kv_block_size=16, prefill_bucket=8,
             spec_draft_len=3)


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=2, num_attention_heads=2,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=64, max_position_embeddings=64,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    jc = jllama2("7b", **_kw())
    jp = jmodel.init_params(jax.random.key(0), jc)
    jd = jdraft_model("tiny", jc).cfg
    jdp = jmodel.init_params(jax.random.key(1), jd)

    def port(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

    return dict(jc=jc, jp=jp, jd=jd, jdp=jdp, tc=tllama2("7b", **_kw()),
                tp=port(jp), td=draft_model("tiny", tllama2("7b", **_kw())),
                tdp=port(jdp))


def _mixed_batch():
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, 128, n).tolist() for n in (3, 17, 30, 9)]
    return prompts, [12, 7, 10, 5]


def _reference(jc, jp, prompt, max_new):
    total = len(prompt) + max_new
    toks = np.zeros((1, total), np.int32)
    toks[0, :len(prompt)] = prompt
    out = generate_tokens(jc, jp, jnp.asarray(toks),
                          jnp.asarray([len(prompt)], jnp.int32),
                          eos_id=-1, use_eos_stop=False)
    return np.asarray(out.tokens)[0].tolist()


def _run(engine, prompts, max_news, **kw):
    engine.start()
    try:
        hs = [engine.submit(p, max_new_tokens=n, use_eos_stop=False, **kw)
              for p, n in zip(prompts, max_news)]
        return [h.result(timeout=600) for h in hs], engine.metrics.snapshot()
    finally:
        engine.shutdown()


def _port(m, fused=True, draft="tiny", **kw):
    tc = dataclasses.replace(m["tc"], fused_decode=fused)
    dcfg, dparams = ((m["td"], m["tdp"]) if draft == "tiny" else (tc, m["tp"]))
    return ServingEngine(tc, m["tp"], EngineConfig(**{**SLICE, **kw}),
                         draft_cfg=dcfg, draft_params=dparams, device="cpu")


@pytest.fixture(scope="module")
def jax_run(models):
    engine = JServingEngine(
        dataclasses.replace(models["jc"], fused_decode=False), models["jp"],
        JEngineConfig(**SLICE), draft_cfg=models["jd"],
        draft_params=models["jdp"])
    return _run(engine, *_mixed_batch())


def test_draft_model_matches_jax(models):
    jd, td = models["jd"], models["td"]
    for f in ("vocab_size", "make_vocab_size_divisible_by", "seq_length",
              "max_position_embeddings", "hidden_size", "num_layers",
              "num_attention_heads", "num_kv_heads"):
        assert getattr(td, f) == getattr(jd, f), f
    assert draft_model("tiny", models["tc"],
                       params_dtype="bfloat16").params_dtype == "bfloat16"


@pytest.mark.parametrize("fused", [True, False], ids=["k14-tree", "composed"])
def test_tiny_draft_engine_matches_jax(models, jax_run, fused):
    """Greedy tokens with a random ``tiny`` draft equal the JAX engine's
    with the same draft, and so do the speculation counters: the draft
    proposes the same trees (its logits within fp32 reassociation, its
    top-2 the same) and the target accepts the same tokens."""
    want, jsnap = jax_run
    results, snap = _run(_port(models, fused), *_mixed_batch())
    assert [r.tokens for r in results] == [r.tokens for r in want]
    assert snap["spec_steps"] > 0
    assert snap["spec_by_source"] == jsnap["spec_by_source"]
    assert set(snap["spec_by_source"]) == {"model"}
    routes = snap["step_routes"]["fp32"]
    assert routes["fallback" if fused else "fused"] == 0


def test_tree_steps_launch_the_tree_mode(models, monkeypatch):
    """On the fused route every tree verify goes through K14's tree mode
    (its wrapper), once a verify step."""
    from megatron_llm_tpu_torch.kernels import decode_step as ds

    calls = {"tree": 0}
    real = ds.fused_decode_verify_tree_paged_plain

    def counted(*a, **k):
        calls["tree"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ds, "fused_decode_verify_tree_paged_plain", counted)
    engine = _port(models, True)
    _, snap = _run(engine, *_mixed_batch())
    assert engine._fused_verify and not engine._fused_draft
    assert calls["tree"] == snap["spec_steps"] > 0


@pytest.mark.parametrize("pipelined", [True, False])
def test_tree_spec_trajectories_equal_the_reference(models, pipelined):
    """Greedy trajectories equal the non-speculative reference in
    pipelined and sync decode, and a sampled rider gives the same stream
    in both modes (tree commits leave its seed and counter alone)."""
    prompts, news = _mixed_batch()
    engine = _port(models, pipeline_decode=pipelined).start()
    try:
        hs = [engine.submit(p, n, use_eos_stop=False)
              for p, n in zip(prompts, news)]
        rider = engine.submit(prompts[0], 8, temperature=0.9, top_k=5,
                              seed=7, use_eos_stop=False)
        results = [h.result(600) for h in hs]
        rider = rider.result(600).tokens
    finally:
        engine.shutdown()
    for p, n, r in zip(prompts, news, results):
        assert r.tokens == _reference(models["jc"], models["jp"], p, n)
    off = _port(models, pipeline_decode=pipelined, spec_draft_len=0)
    res, snap = _run(off, [prompts[0]], [8], temperature=0.9, top_k=5,
                     seed=7)
    assert rider == res[0].tokens and snap["spec_steps"] == 0


@pytest.mark.parametrize("fused", [True, False], ids=["k14-tree", "composed"])
def test_perfect_draft_acceptance(models, fused):
    """A self-draft proposes the target's own argmax: the main chains are
    always accepted (the hedge never is), so the rate is high and the
    tokens are the reference's."""
    prompts, news = _mixed_batch()
    engine = _port(models, fused, draft="self")
    results, snap = _run(engine, prompts, news)
    assert engine._fused_draft == fused
    for p, n, r in zip(prompts, news, results):
        assert r.tokens == _reference(models["jc"], models["jp"], p, n)
    rate = snap["spec_accepted"] / max(1, snap["spec_proposed"])
    assert rate > 0.5, snap
    assert snap["accepted_tokens_per_step"]["mean"] > 2.0


def test_eos_mid_tree(models):
    """EOS inside an accepted path: generation stops at the EOS token with
    the reference's prefix; the drafted tokens past it never surface."""
    prompt = [5, 9, 3]
    ref = _reference(models["jc"], models["jp"], prompt, 8)
    gen = ref[len(prompt):]
    eos = gen[2]
    engine = _port(models, draft="self").start()
    try:
        r = engine.submit(prompt, max_new_tokens=8,
                          eos_id=eos).result(timeout=600)
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None
    assert r.finish_reason == "eos"
    assert r.tokens == ref[:len(prompt) + gen.index(eos) + 1]
    assert engine.metrics.snapshot()["spec_steps"] > 0


@pytest.mark.parametrize("fused", [True, False], ids=["k14-tree", "composed"])
def test_forced_hedge_compaction(models, monkeypatch, fused):
    """The draft's heads patched so the main chain carries a wrong token
    and the hedge the true one: acceptance lands on a node whose index is
    not its depth, and ``cache_move_rows`` packs it; tokens stay the
    reference's."""
    real = tengine.ServingEngine._draft_absorb
    hits = {"n": 0}

    def fake_absorb(self, plans, tables):
        out = {}
        for slot, toks in real(self, plans, tables).items():
            out[slot] = [(int(toks[0]) + 1) % 128, int(toks[0])]
            hits["n"] += 1
        return out

    moves = {"n": 0}
    real_move = tengine.model_lib.cache_move_rows

    def counted_move(*a, **k):
        moves["n"] += 1
        return real_move(*a, **k)

    monkeypatch.setattr(tengine.ServingEngine, "_draft_absorb", fake_absorb)
    monkeypatch.setattr(tengine.model_lib, "cache_move_rows", counted_move)
    prompts, news = _mixed_batch()
    results, snap = _run(_port(models, fused, draft="self"), prompts, news)
    for p, n, r in zip(prompts, news, results):
        assert r.tokens == _reference(models["jc"], models["jp"], p, n)
    assert hits["n"] > 0 and moves["n"] > 0
    assert snap["spec_accepted"] > 0


def test_block_boundary_ledger_balanced(models):
    """Trees straddling 16-token block edges (draft_len 3, prompts that end
    at 15 and 31 tokens): after every request retires, the only blocks in
    use are the prefix cache's, each held once, and the reservations are
    all returned."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, n).tolist() for n in (15, 31, 14, 30)]
    news = [20, 12, 17, 9]
    engine = _port(models, draft="self")
    results, snap = _run(engine, prompts, news)
    for p, n, r in zip(prompts, news, results):
        assert r.tokens == _reference(models["jc"], models["jp"], p, n)
    pool = engine.slots.pool
    assert snap["spec_steps"] > 0
    assert pool.reserved_blocks == 0
    assert pool.used_blocks == engine.prefix_cache.blocks
    assert set(pool.ref_counts().values()) <= {1}
    assert engine.slots.free_slots == SLICE["max_batch_size"]


def test_service_plumbs_the_draft(models):
    svc = GenerationService(models["tc"], models["tp"], NullTokenizer(127),
                            max_batch_size=2, engine_max_seq_len=64,
                            kv_block_size=16, spec_draft_len=3,
                            draft_cfg=models["td"],
                            draft_params=models["tdp"], device="cpu")
    try:
        status, out = svc.handle({"prompts": ["5 6 7 8"],
                                  "tokens_to_generate": 6,
                                  "no_early_termination": True})
        assert status == 200
        snap = svc.metrics_snapshot()
        assert snap["spec_by_source"]["model"]["steps"] > 0
        assert svc.engine._draft_enabled
    finally:
        svc.close()
    want = _reference(models["jc"], models["jp"], [5, 6, 7, 8], 6)
    assert [int(t) for t in out["text"][0].split()] == want


def test_draft_needs_params_and_the_target_vocab(models):
    tc, tp = models["tc"], models["tp"]
    with pytest.raises(ValueError, match="draft_params"):
        ServingEngine(tc, tp, EngineConfig(**SLICE), draft_cfg=tc,
                      device="cpu")
    other = dataclasses.replace(models["td"], vocab_size=64)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tc, tp, EngineConfig(**SLICE), draft_cfg=other,
                      draft_params=models["tdp"], device="cpu")
