"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same tiny weights (JAX's, carried across with
``params_from_jax``) and the slice's configuration: paged KV with 8-token
blocks, prefill padded to 8, no prefix cache, no tracing, and
``cfg.fused_decode=False``.  Five mixed-length requests over two slots
exercise queueing, admission and retirement.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.serving import (
    EngineConfig,
    QueueFull,
    ServingEngine,
)

torch.set_num_threads(1)

SLICE = dict(max_batch_size=2, max_seq_len=64, kv_block_size=8,
             prefill_bucket=8, prefix_cache_blocks=0, trace=False)
LENS = (3, 9, 5, 14, 7)
NEW = (6, 4, 9, 5, 7)
# fp32 logprobs through two layers on both sides; sums in another order
LOGPROB_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jc = jtiny(fused_decode=False)
    tc = ttiny(fused_decode=False)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 250, n).tolist() for n in LENS]


def _run(engine, prompts, news, **kw):
    engine.start()
    try:
        handles = [engine.submit(p, n, use_eos_stop=False, **kw)
                   for p, n in zip(prompts, news)]
        return [h.result(timeout=300) for h in handles], \
            engine.metrics.snapshot()
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def jax_greedy(weights):
    jc, jp, _, _ = weights
    engine = JServingEngine(jc, jp, JEngineConfig(**SLICE))
    res, _ = _run(engine, _prompts(), NEW, return_logprobs=True)
    return res


def _engine(weights, **kw):
    _, _, tc, tp = weights
    return ServingEngine(tc, tp, EngineConfig(**{**SLICE, **kw}),
                         device="cpu")


@pytest.mark.parametrize("pipeline", [True, False])
def test_greedy_tokens_match_jax(weights, jax_greedy, pipeline):
    res, snap = _run(_engine(weights, pipeline_decode=pipeline), _prompts(),
                     NEW, return_logprobs=True)
    assert snap["completed"] == len(LENS)
    assert snap["max_decode_batch"] == 2  # two slots shared decode steps
    for want, got in zip(jax_greedy, res):
        assert got.tokens == want.tokens
        assert got.prompt_len == want.prompt_len
        assert got.finish_reason == want.finish_reason == "length"
        # prompt positions and generated tokens alike
        assert len(got.logprobs) == len(want.logprobs)
        np.testing.assert_allclose(got.logprobs, want.logprobs,
                                   **LOGPROB_TOL)


def test_sampled_invariants(weights):
    """Sampling cannot match jax.random draw for draw; it keeps the JAX
    engine's invariants: the same seed gives the same tokens, whatever
    slot the request lands in and whoever shares its batch; another seed
    gives other tokens."""
    spec = dict(prompt=[5, 9, 3], max_new_tokens=10, use_eos_stop=False,
                temperature=0.8, top_k=8, seed=123)
    nucleus = dict(spec, top_k=0, top_p=0.9, seed=7)
    engine = _engine(weights).start()
    try:
        alone = engine.submit(**spec).result(timeout=300)
        alone_p = engine.submit(**nucleus).result(timeout=300)
        engine.pause()  # a companion is admitted first: spec lands in slot 1
        comp = engine.submit([7, 11, 13, 17], max_new_tokens=12,
                             use_eos_stop=False)
        h = engine.submit(**spec)
        h_p = engine.submit(**nucleus)
        engine.resume()
        shared, shared_p = h.result(timeout=300), h_p.result(timeout=300)
        comp.result(timeout=300)
        reseeded = engine.submit(**{**spec, "seed": 124}).result(timeout=300)
    finally:
        engine.shutdown()
    assert shared.tokens == alone.tokens
    assert shared_p.tokens == alone_p.tokens
    assert reseeded.tokens != alone.tokens  # overwhelmingly
    generated = alone.tokens[3:]
    assert len(generated) == 10 and all(0 <= t < 256 for t in generated)


def test_eos_stop_and_streaming(weights, jax_greedy):
    """EOS retires the request with the EOS token included; on_token
    streams exactly the committed tokens."""
    want = jax_greedy[2]
    gen = want.tokens[want.prompt_len:]
    eos = gen[3]
    cut = gen.index(eos) + 1
    streamed = []
    engine = _engine(weights).start()
    try:
        r = engine.submit(_prompts()[2], NEW[2], eos_id=eos,
                          on_token=streamed.append).result(timeout=300)
    finally:
        engine.shutdown()
    assert r.finish_reason == "eos"
    assert r.tokens == want.tokens[:want.prompt_len + cut]
    assert streamed == r.tokens[r.prompt_len:]


def test_cancel_deadline_drain_shutdown(weights):
    engine = _engine(weights).start()
    try:
        engine.pause()
        queued = engine.submit([1, 2, 3], 20, use_eos_stop=False)
        late = engine.submit([4, 5], 20, use_eos_stop=False, deadline_s=0.0)
        queued.cancel()
        assert queued.result(timeout=60).finish_reason == "cancelled"
        engine.resume()
        assert late.result(timeout=60).finish_reason == "timeout"
        # a running request cancelled mid-decode keeps what it committed
        first = threading.Event()
        running = engine.submit([9, 8, 7], 40, use_eos_stop=False,
                                on_token=lambda t: first.set())
        assert first.wait(60)
        running.cancel()
        r = running.result(timeout=60)
        assert r.finish_reason == "cancelled"
        assert 1 <= len(r.tokens) - r.prompt_len < 40
        ok = engine.submit([3, 4], 4, use_eos_stop=False)
        assert engine.drain(timeout=60)
        assert ok.result(timeout=1).finish_reason == "length"
        with pytest.raises(QueueFull):
            engine.submit([1], 2)
        snap = engine.metrics.snapshot()
        assert snap["cancelled"] == 2 and snap["timeouts"] == 1
        assert engine.kv_snapshot()["pool"]["blocks_used"] == 0
    finally:
        engine.shutdown()
    assert engine._thread is None


def test_admission_validation(weights):
    engine = _engine(weights)
    try:
        with pytest.raises(ValueError, match="empty prompt"):
            engine.submit([], max_new_tokens=4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit([5], max_new_tokens=0)
        with pytest.raises(ValueError, match="sequence budget"):
            engine.submit(list(range(1, 61)), max_new_tokens=5)  # 65 > 64
        assert engine.metrics.snapshot()["rejected_invalid"] == 3
    finally:
        engine.shutdown()


def test_engine_config_fields_match_jax():
    import dataclasses

    t, j = EngineConfig(), JEngineConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# options the engine serves: their cases check the tokens against the JAX
# engine's with the same option (tests/test_torch_chunked_prefill.py,
# test_torch_tiered_kv.py and test_torch_sanitizers.py go further)
NOW_PORTED = ("prefill_chunk", "host_kv_blocks", "sanitize", "int8")


@pytest.mark.parametrize("kw,cfg_kw,match", [
    (dict(prefill_chunk=16), {}, "prefill_chunk"),
    (dict(host_kv_blocks=4), {}, "host_kv_blocks"),
    (dict(role="prefill"), {}, "role"),
    (dict(sanitize=True), {}, "sanitize"),
    # a model with W8A8 training matmuls is served on the composed route
    ({}, dict(quantize_matmuls="int8"), "int8"),
])
def test_unported_options_raise(weights, kw, cfg_kw, match):
    jc, jp, _, tp = weights
    tc = ttiny(**{"fused_decode": False, **cfg_kw})
    if match in NOW_PORTED:
        jc = dataclasses.replace(jc, **cfg_kw)
        got, _ = _run(ServingEngine(tc, tp, EngineConfig(**{**SLICE, **kw}),
                                    device="cpu"), _prompts(), NEW)
        want, _ = _run(JServingEngine(jc, jp, JEngineConfig(**{**SLICE,
                                                             **kw})),
                       _prompts(), NEW)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        return
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*ROADMAP"):
        ServingEngine(tc, tp, EngineConfig(**{**SLICE, **kw}), device="cpu")


def test_draft_model_mesh_and_quantized_weights_raise(weights):
    """A mesh no longer raises: a mesh of one rank serves the plain
    engine's tokens (sharded meshes are served,
    ``tests/test_torch_sharded_serving.py``), while a disaggregated role
    still raises.  A resident draft model no longer does (it is served,
    ``tests/test_torch_draft_serving.py``), nor do quantized weights
    (they are served through ``ops/quant.mm``).  A W8A8 training config
    over serving-quantized weights is served too: such a weight goes
    through ``mm``, not the int8 training matmul, so its tokens are the
    quantized engine's."""
    from megatron_llm_tpu_torch.config import ParallelConfig as TPar
    from megatron_llm_tpu_torch.ops.quant import quantize_params
    from megatron_llm_tpu_torch.parallel import mesh as tmesh

    _, _, tc, tp = weights
    ec = EngineConfig(**SLICE)
    meshed = ServingEngine(tc, tp, ec, mesh=tmesh.build_mesh(TPar()),
                           device="cpu")
    got, _ = _run(meshed, _prompts(), NEW)
    want, _ = _run(ServingEngine(tc, tp, ec, device="cpu"), _prompts(), NEW)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    with pytest.raises(NotImplementedError, match="role.*ROADMAP"):
        ServingEngine(tc, tp, EngineConfig(**SLICE, role="prefill"),
                      device="cpu")
    quant = quantize_params(tp, "int8")
    engine = ServingEngine(tc, quant, ec, device="cpu")
    assert engine._precision_route == "int8"
    w8a8 = ServingEngine(ttiny(fused_decode=False, quantize_matmuls="int8"),
                         quant, ec, device="cpu")
    assert w8a8._precision_route == "int8"
    got, _ = _run(w8a8, _prompts(), NEW)
    want, _ = _run(engine, _prompts(), NEW)
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_queue_full_backpressure(weights):
    engine = _engine(weights, max_queue_size=2).start()
    try:
        engine.pause()
        hs = [engine.submit([1, 2], 3, use_eos_stop=False) for _ in range(2)]
        with pytest.raises(QueueFull):
            engine.submit([1, 2], 3)
        engine.resume()
        t0 = time.perf_counter()
        assert all(h.result(timeout=60).finish_reason == "length" for h in hs)
        assert time.perf_counter() - t0 < 60
        assert engine.metrics.snapshot()["rejected_queue_full"] == 1
    finally:
        engine.shutdown()
