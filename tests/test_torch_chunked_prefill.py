"""Chunked prefill in the port's engine, against the JAX engine's, on the
CPU (mirror of ``tests/serving/test_engine.py``'s chunked cases:
``TestPagedEquivalence.test_fp32_chunked_admission`` (pipelined and
sync), ``test_int8_chunked_pipelined`` and
``TestSpeculative.test_composes_with_chunked_prefill_and_prefix_cache``),
plus the shapes that stress the chunk cursor: a prefix hit over the paged
pool (blocks the chunk's size and smaller), a prompt that is an exact
multiple of the chunk, one shorter than a chunk, and ``return_logprobs``
(which takes the whole-prompt route, as in JAX).

Each case serves the same prompts through the port with
``prefill_chunk``, through the port without it, and through the JAX
engine with it: the greedy tokens of all three are equal (fp32 and int8
on the CPU: exactly), and ``prefill_chunks`` equals the JAX engine's
count where both take the same chunks (the block size the chunk's).  The
port runs JAX's weights (``params_from_jax``); logprobs agree with JAX's
to 1e-4 (fp32 through two layers, sums in another order) and with the
port's whole-prompt route exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops.quant import quantize_params as jquantize
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine

torch.set_num_threads(1)

CFG = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8,
           fused_decode=False)
REP_PROMPTS = [[5, 9, 3, 5, 9, 3, 5, 9, 3, 5, 9],
               [7, 7, 7, 7, 7, 7, 7],
               [4, 8, 2, 4, 8, 2, 4, 8],
               [11, 6, 11, 6, 11, 6, 11]]


@pytest.fixture(scope="module")
def models():
    jc, tc = jtiny(**CFG), ttiny(**CFG)
    jp = jm.init_params(jax.random.key(0), jc)
    jq = jquantize(jp)
    jc8 = dataclasses.replace(jc, kv_cache_quant="int8")
    tc8 = dataclasses.replace(tc, kv_cache_quant="int8")
    return {
        "fp32": (jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")),
        "int8": (jc8, jq, tc8, params_from_jax(
            jax.tree.map(np.asarray, jq), device="cpu")),
    }


def _ragged():
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, CFG["vocab_size"], n).tolist()
               for n in (3, 17, 30, 9)]       # 1..4 blocks at bk = 8
    return [(p, n) for p, n in zip(prompts, (20, 9, 14, 5))]


def _shared_prefix():
    """Sequential prompts over one 19-token prefix: a cold run, its
    repeat, and two that go their own way after it."""
    rng = np.random.default_rng(41)
    base = rng.integers(1, CFG["vocab_size"], 19).tolist()
    tails = [rng.integers(1, CFG["vocab_size"], n).tolist() for n in (5, 9)]
    return [(base, 8), (base, 8), (base + tails[0], 8), (base + tails[1], 8)]


def _serve(engine, jobs, sequential, **req):
    engine.start()
    try:
        if sequential:
            results = [engine.submit(p, max_new_tokens=n, use_eos_stop=False,
                                     **req).result(timeout=600)
                       for p, n in jobs]
        else:
            handles = [engine.submit(p, max_new_tokens=n, use_eos_stop=False,
                                     **req) for p, n in jobs]
            results = [h.result(timeout=600) for h in handles]
    finally:
        engine.shutdown()
    assert getattr(engine, "_scheduler_error", None) is None
    return results, engine.metrics.snapshot()


# name: (model, jobs, engine config, sequential, request kw, chunks agree)
CASES = {
    "fp32_pipelined": ("fp32", _ragged(), dict(
        kv_block_size=8, prefill_chunk=8, pipeline_decode=True), False, {},
        True),
    "fp32_sync": ("fp32", _ragged(), dict(
        kv_block_size=8, prefill_chunk=8, pipeline_decode=False), False, {},
        True),
    "int8_pipelined": ("int8", _ragged(), dict(
        kv_block_size=8, prefill_chunk=8, pipeline_decode=True), False, {},
        True),
    "spec_prefix_cache": ("fp32", [(p, 20) for p in REP_PROMPTS], dict(
        kv_block_size=8, prefill_chunk=8, prefix_cache_blocks=16,
        spec_draft_len=3), False, {}, True),
    "prefix_hit_paged": ("fp32", _shared_prefix(), dict(
        kv_block_size=8, prefill_chunk=8, prefix_cache_blocks=16), True, {},
        True),
    "prefix_hit_small_blocks": ("fp32", _shared_prefix(), dict(
        kv_block_size=4, prefill_chunk=8, prefix_cache_blocks=16), True, {},
        False),
    "exact_multiple": ("fp32", [(list(range(1, 17)), 10),
                                (list(range(40, 64)), 6)],
                       dict(prefill_chunk=8), False, {}, True),
    "shorter_than_chunk": ("fp32", [([3, 1, 4, 1, 5], 12), ([9, 2], 7)],
                           dict(prefill_chunk=8), False, {}, True),
    "return_logprobs": ("fp32", _ragged()[:2], dict(
        kv_block_size=8, prefill_chunk=8), False,
        dict(return_logprobs=True), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_tokens_equal_jax_and_whole_prompt(models, case):
    model, jobs, ec, sequential, req, chunks_agree = CASES[case]
    jc, jp, tc, tp = models[model]
    base = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16)
    chunked, snap = _serve(
        ServingEngine(tc, tp, EngineConfig(**base, **ec), device="cpu"),
        jobs, sequential, **req)
    whole_ec = {k: v for k, v in ec.items() if k != "prefill_chunk"}
    if "kv_block_size" not in whole_ec:
        whole_ec["kv_block_size"] = ec["prefill_chunk"]
    whole, _ = _serve(
        ServingEngine(tc, tp, EngineConfig(**base, **whole_ec),
                      device="cpu"), jobs, sequential, **req)
    jax_out, jsnap = _serve(
        JServingEngine(jc, jp, JEngineConfig(**base, **ec)), jobs,
        sequential, **req)
    for (p, n), c, w, j in zip(jobs, chunked, whole, jax_out):
        assert c.finish_reason == "length" and len(c.tokens) == len(p) + n
        assert c.tokens == j.tokens, "chunked tokens differ from JAX's"
        assert c.tokens == w.tokens, "chunked differs from whole-prompt"
        if req.get("return_logprobs"):
            assert c.logprobs == w.logprobs
            np.testing.assert_allclose(c.logprobs, j.logprobs, atol=1e-4)
    if req.get("return_logprobs"):
        assert snap["prefill_chunks"] == 0  # the whole-prompt route
    else:
        assert snap["prefill_chunks"] >= len(jobs)
    if chunks_agree:
        assert snap["prefill_chunks"] == jsnap["prefill_chunks"]
    for key in ("completed", "admitted", "prefills", "prefix_hits"):
        assert snap[key] == jsnap[key], key
    if case.startswith("fp32"):
        assert snap["prefill_chunks"] > 4  # really chunk at a time
    if case == "spec_prefix_cache":
        assert snap["spec_steps"] > 0
    if case.startswith("prefix_hit"):
        assert snap["prefix_hits"] == 3


def test_chunked_hit_resumes_at_a_chunk_start(models):
    """With blocks smaller than the chunk, a hit restarts at the last chunk
    start at or before its match: a repeat of a 19-token prompt (match 16
    at bk = 4, chunk 8) runs the cold run's last chunk, 16..19, as its one
    chunk; a cold 19-token prompt takes three."""
    _, _, tc, tp = models["fp32"]
    base = dict(max_batch_size=2, max_seq_len=64, kv_block_size=4,
                prefill_chunk=8, prefix_cache_blocks=16)
    engine = ServingEngine(tc, tp, EngineConfig(**base), device="cpu")
    prompt = _shared_prefix()[0][0]
    (cold, hit), snap = _serve(engine, [(prompt, 8), (prompt, 8)], True)
    assert cold.tokens == hit.tokens
    assert snap["prefix_hits"] == 1
    assert snap["prefill_chunks"] == 3 + 1
    spans = [e for e in engine.trace.chrome_trace()["traceEvents"]
             if e["name"].startswith("prefill_chunk")]
    assert [e["args"]["off"] for e in spans] == [0, 8, 16, 16]
