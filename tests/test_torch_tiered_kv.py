"""Tiered KV in the port, against the JAX package's, on the CPU (mirror of
``tests/serving/test_tiered_kv.py``, case for case): block contents
round-trip the host arena bitwise (fp32 and int8 ``{q, scale}`` pools),
the tier's ledger and bandwidth bound, the priority queue, a preempted
decode resumes bitwise (greedy and sampled), an oversubscribed storm keeps
every ledger balanced, the steady state compiles nothing, the kv snapshot
and metrics report the tier, a spilled prefix promoted on a hit serves the
never-evicted hit's tokens, and chaos faults at ``host-swap-out`` /
``host-swap-in`` lose nothing.

Config: the tiny preset (2 layers, vocab 64, fp32) with JAX's weights
carried across by ``params_from_jax``, 8-token blocks.  Greedy tokens are
held equal to JAX's ``generate_tokens`` on the same weights; in the
deterministic preemption case also to the JAX engine's tokens and its
preemption / resume counters (exactly; fp32 on the CPU, no tolerance).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation import generate_tokens
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.analysis.sanitizers import no_recompiles
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.resilience.chaos import chaos
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving.block_pool import BlockPool, HostKVTier
from megatron_llm_tpu_torch.serving.queue import RequestQueue

torch.set_num_threads(1)

CFG = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8,
           fused_decode=False)


def _models(quant=None):
    jc, tc = jtiny(**CFG), ttiny(**CFG)
    if quant:
        jc = dataclasses.replace(jc, kv_cache_quant=quant)
        tc = dataclasses.replace(tc, kv_cache_quant=quant)
    jp = jm.init_params(jax.random.key(0), jc)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _models()


def _engine(cfg, params, **overrides):
    kw = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16,
              idle_wait_s=0.005, kv_block_size=8)
    kw.update(overrides)
    return ServingEngine(cfg, params, EngineConfig(**kw), device="cpu")


def _reference(jc, jp, prompt, max_new):
    """JAX's ``generate_tokens`` on the same weights: the tokens every
    engine run here must commit."""
    total = len(prompt) + max_new
    toks = np.zeros((1, total), np.int32)
    toks[0, :len(prompt)] = prompt
    out = generate_tokens(jc, jp, jnp.asarray(toks),
                          jnp.asarray([len(prompt)], jnp.int32),
                          eos_id=-1, use_eos_stop=False)
    return np.asarray(out.tokens)[0].tolist()


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], n).tolist()


# ---------------------------------------------------------------------------
# HostKVTier unit: bitwise round trip, ledger, bandwidth bound
# ---------------------------------------------------------------------------


def _leaves(cache):
    return list(cache.values()) if isinstance(cache, dict) else [cache]


def _patterned_pool(cfg, n_blocks, bk, bids):
    """A pool whose ``bids`` carry recognisable contents."""
    pool = BlockPool(cfg, n_blocks, bk, device="cpu")
    for leaf in _leaves(pool.k_pool) + _leaves(pool.v_pool):
        for bid in bids:
            n = leaf[:, bid].numel()
            fill = (torch.arange(n, dtype=torch.float64) % 97 + bid)
            leaf[:, bid] = fill.reshape(leaf[:, bid].shape).to(leaf.dtype)
    return pool


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_host_tier_roundtrip_bitwise(quant):
    """demote -> pump -> promote restores the exact bytes into fresh
    blocks, and the pool's tensors are written in place."""
    cfg = ttiny(**CFG)
    if quant == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
    pool = _patterned_pool(cfg, 8, 4, bids=[1, 2, 3])
    before = [t.clone() for t in _leaves(pool.k_pool) + _leaves(pool.v_pool)]
    ptrs = [t.data_ptr() for t in _leaves(pool.k_pool) + _leaves(pool.v_pool)]
    tier = HostKVTier(pool, n_host_blocks=4, arity=4)

    pool.reserve(3)
    src = [pool.alloc_reserved() for _ in range(3)]
    assert sorted(src) == [1, 2, 3]
    hids = tier.begin_demote(src, owner="req-a")
    assert tier.in_flight == 1 and tier.host_used == 3
    for bid in src:
        pool.decref(bid)  # the staged leaves own the bytes now
    assert tier.pump() == 1
    assert tier.in_flight == 0
    assert tier.bw_bytes_per_s > 0 and tier.bw_bytes_per_s != float("inf")

    pool.reserve(3)
    dst = [pool.alloc_reserved() for _ in range(3)]
    tier.promote(hids, dst)
    tier.free(hids)
    assert tier.host_used == 0 and tier.owners() == {}

    after = _leaves(pool.k_pool) + _leaves(pool.v_pool)
    assert [t.data_ptr() for t in after] == ptrs
    for b, a in zip(before, after):
        for s, d in zip(src, dst):
            assert torch.equal(a[:, d], b[:, s])


def test_host_tier_ledger_and_bandwidth_bound():
    pool = BlockPool(ttiny(**CFG), 8, 4, device="cpu")
    tier = HostKVTier(pool, n_host_blocks=2, arity=4)
    assert tier.can_store(2) and not tier.can_store(3)
    assert tier.swap_ok()  # an empty backlog is always ok
    pool.reserve(2)
    bids = [pool.alloc_reserved(), pool.alloc_reserved()]
    hids = tier.begin_demote(bids, owner="r1")
    with pytest.raises(RuntimeError):
        tier.free(hids)  # still in flight
    tier.pump()
    with pytest.raises(RuntimeError):
        tier.begin_demote(bids, owner="r2")  # tier exhausted
    tier.free(hids)
    with pytest.raises(RuntimeError):
        tier.free(hids)  # double free caught
    stats = tier.stats()
    assert stats["swap_out_blocks"] == 2 and stats["host_blocks_free"] == 2


def test_priority_queue_pop_order():
    """Highest class first, FIFO within a class, FIFO when untagged."""

    class R:
        def __init__(self, name, priority=0):
            self.name, self.priority = name, priority

    q = RequestQueue(max_size=8)
    q.put_many([R("a"), R("b", 2), R("c"), R("d", 2), R("e", 1)])
    assert [q.pop().name for _ in range(5)] == ["b", "d", "e", "a", "c"]
    assert q.pop() is None
    q.put_many([R("x"), R("y"), R("z")])
    assert [q.pop().name for _ in range(3)] == ["x", "y", "z"]


# ---------------------------------------------------------------------------
# Engine: bitwise preemption / resume, oversubscription, observability
# ---------------------------------------------------------------------------

# 6 usable blocks and the victim reserves 4: the high-priority admission
# cannot reserve without suspending the low-priority decode
_PREEMPT_KW = dict(max_batch_size=2, kv_pool_blocks=7, host_kv_blocks=8,
                   prefix_cache_blocks=0, sanitize=True)


def _run_preemption(engine):
    """A low-priority decode and a high-priority arrival that must preempt
    it: ``(low_result, high_result, low_prompt, hi_prompt, low_new,
    hi_new)``."""
    low_prompt, hi_prompt = _prompt(17, 5), _prompt(9, 6)
    low_new, hi_new = 12, 10
    started = threading.Event()
    h_low = engine.submit(low_prompt, max_new_tokens=low_new,
                          use_eos_stop=False, priority=0,
                          on_token=lambda t: started.set())
    assert started.wait(timeout=600), "low-priority decode never started"
    h_hi = engine.submit(hi_prompt, max_new_tokens=hi_new,
                         use_eos_stop=False, priority=1)
    r_hi = h_hi.result(timeout=600)
    r_low = h_low.result(timeout=600)
    return r_low, r_hi, low_prompt, hi_prompt, low_new, hi_new


_PREEMPT_COUNTERS = ("preemptions_total", "resumes_total", "completed")


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_preempt_resume_bitwise(quant):
    """A suspended-and-resumed decode commits the tokens an uninterrupted
    run commits, and those of the JAX engine in the same scenario, whose
    preemption counters it matches."""
    jc, jp, tc, tp = _models("int8" if quant == "int8" else None)
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        r_low, r_hi, low_p, hi_p, low_n, hi_n = _run_preemption(engine)
        snap = engine.metrics.snapshot()
        assert snap["preemptions_total"] >= 1, snap
        assert snap["resumes_total"] >= 1, snap
        assert snap["swap_out_blocks_total"] >= 1
        assert snap["swap_in_blocks_total"] >= 1
        engine.drain(timeout=60)
        assert engine.sanitizer_report == []
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert r_low.tokens == _reference(jc, jp, low_p, low_n)
    assert r_hi.tokens == _reference(jc, jp, hi_p, hi_n)

    jengine = JServingEngine(jc, jp, JEngineConfig(
        max_batch_size=2, max_seq_len=64, max_queue_size=16,
        idle_wait_s=0.005, kv_block_size=8, kv_pool_blocks=7,
        host_kv_blocks=8, prefix_cache_blocks=0)).start()
    try:
        j_low, j_hi = _run_preemption(jengine)[:2]
        jsnap = jengine.metrics.snapshot()
    finally:
        jengine.shutdown()
    assert (r_low.tokens, r_hi.tokens) == (j_low.tokens, j_hi.tokens)
    assert {k: snap[k] for k in _PREEMPT_COUNTERS} == \
        {k: jsnap[k] for k in _PREEMPT_COUNTERS}


def test_preempt_resume_sampled_rng_carried(tiny):
    """A sampled low-priority request keeps its ``(seed, count)`` fold
    through the suspension: the resumed samples continue the stream a
    never-preempted run draws."""
    _, _, tc, tp = tiny
    low_prompt = _prompt(17, 7)
    spec = dict(max_new_tokens=12, temperature=0.9, top_k=5, seed=11,
                use_eos_stop=False)
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        baseline = engine.submit(low_prompt, **spec).result(timeout=600)
        assert engine.metrics.snapshot()["preemptions_total"] == 0
    finally:
        engine.shutdown()
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        started = threading.Event()
        h_low = engine.submit(low_prompt, priority=0,
                              on_token=lambda t: started.set(), **spec)
        assert started.wait(timeout=600)
        h_hi = engine.submit(_prompt(9, 8), max_new_tokens=10,
                             use_eos_stop=False, priority=1)
        h_hi.result(timeout=600)
        preempted = h_low.result(timeout=600)
        assert engine.metrics.snapshot()["preemptions_total"] >= 1
        engine.drain(timeout=60)
        assert engine.sanitizer_report == []
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert preempted.tokens == baseline.tokens


def test_oversubscribed_storm_ledgers_balanced(tiny):
    """An admission storm at 2x logical oversubscription, sanitizers on:
    mixed-priority requests whose worst-case reservations exceed the pool
    by design.  Every request completes with JAX's reference tokens,
    preemptions fire and all resume, and the drain report is clean."""
    jc, jp, tc, tp = tiny
    # each request needs 4 of the 6 usable blocks: two never co-reside,
    # so each higher class arriving must preempt the running lower one
    engine = _engine(tc, tp, max_batch_size=2, kv_pool_blocks=7,
                     host_kv_blocks=18, prefix_cache_blocks=0,
                     sanitize=True).start()
    jobs = []
    try:
        for i in range(9):
            prompt = _prompt(17, 100 + i)  # 17 + 14 -> 4 blocks
            h = engine.submit(prompt, max_new_tokens=14,
                              use_eos_stop=False, priority=i % 3)
            jobs.append((h, prompt, 14))
            time.sleep(0.01)  # decodes are live when the next class comes
        results = [h.result(timeout=600) for h, _, _ in jobs]
        snap = engine.metrics.snapshot()
        assert snap["preemptions_total"] >= 1, \
            "the storm never preempted; resize the pool"
        assert snap["resumes_total"] == snap["preemptions_total"]
        engine.drain(timeout=120)
        assert engine.sanitizer_report == []
        assert engine.host_tier.host_used == 0
        assert engine.host_tier.in_flight == 0
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    for r, (_, prompt, max_new) in zip(results, jobs):
        assert r.finish_reason == "length"
        assert r.tokens == _reference(jc, jp, prompt, max_new)


def test_tiered_zero_recompiles_after_warmup(tiny):
    """The tier builds nothing: after one warm-up preempt / resume cycle
    the next cycle runs under ``no_recompiles``."""
    jc, jp, tc, tp = tiny
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        _run_preemption(engine)
        assert engine.metrics.snapshot()["preemptions_total"] >= 1
        with no_recompiles() as counter:
            r_low, r_hi, low_p, hi_p, low_n, hi_n = _run_preemption(engine)
        assert counter.count == 0
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert r_low.tokens == _reference(jc, jp, low_p, low_n)
    assert r_hi.tokens == _reference(jc, jp, hi_p, hi_n)


def test_kv_snapshot_and_metrics_surface(tiny):
    """GET /kv and /metrics report the host tier: arena occupancy, each
    suspended request's host block count, the swap and preemption
    counters, the resume-latency reservoir and the Prometheus gauges."""
    _, _, tc, tp = tiny
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        started = threading.Event()
        h_low = engine.submit(_prompt(17, 9), max_new_tokens=30,
                              use_eos_stop=False, priority=0,
                              on_token=lambda t: started.set())
        assert started.wait(timeout=600)
        h_hi = engine.submit(_prompt(9, 10), max_new_tokens=10,
                             use_eos_stop=False, priority=1)
        seen_suspended = {}
        deadline = time.monotonic() + 600
        while not seen_suspended and time.monotonic() < deadline:
            host = engine.kv_snapshot().get("host_tier") or {}
            seen_suspended = dict(host.get("suspended", {}))
            time.sleep(0.002)
        h_hi.result(timeout=600)
        h_low.result(timeout=600)
        assert seen_suspended, "the suspended request never showed in /kv"
        info = seen_suspended[h_low.rid]
        assert info["blocks"] >= 1 and info["priority"] == 0

        host = engine.kv_snapshot()["host_tier"]
        assert host["n_host_blocks"] == 8
        assert host["swap_out_blocks"] >= 1
        assert host["swap_bw_bytes_per_s"] > 0.0

        m = engine.metrics.snapshot()
        assert m["preemptions_total"] >= 1
        assert m["swap_bytes_total"] > 0
        assert m["resume_latency"]["count"] >= 1
        assert m["prefix_promotions_total"] == 0  # no cache configured
        assert "host_blocks_used" in m and "host_blocks_free" in m
        prom_names = {f.name for f in engine.metrics.collect()}
        for name in ("serving_host_blocks_used", "serving_host_blocks_free",
                     "serving_swap_out_blocks_total",
                     "serving_preemptions_total",
                     "serving_resume_latency_seconds"):
            assert name in prom_names
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error


# ---------------------------------------------------------------------------
# Prefix-cache spill -> promote
# ---------------------------------------------------------------------------


def test_prefix_spill_promote_hit_equals_never_evicted(tiny):
    """A prefix evicted under budget pressure spills to the host and serves
    the next identical prompt through a promotion, token for token the
    never-evicted hit's and JAX's reference."""
    jc, jp, tc, tp = tiny
    prompt_a, prompt_b = _prompt(17, 21), _prompt(17, 22)  # 2 blocks each
    max_new = 6
    kw = dict(max_batch_size=2, prefix_cache_blocks=2, host_kv_blocks=8,
              sanitize=True)

    engine = _engine(tc, tp, **kw).start()
    try:
        engine.submit(prompt_a, max_new_tokens=max_new,
                      use_eos_stop=False).result(timeout=600)
        never_evicted = engine.submit(prompt_a, max_new_tokens=max_new,
                                      use_eos_stop=False).result(timeout=600)
        assert engine.metrics.snapshot()["prefix_hits"] >= 1
    finally:
        engine.shutdown()

    engine = _engine(tc, tp, **kw).start()
    try:
        engine.submit(prompt_a, max_new_tokens=max_new,
                      use_eos_stop=False).result(timeout=600)
        # B's retirement overflows the 2-block budget: A's blocks spill
        engine.submit(prompt_b, max_new_tokens=max_new,
                      use_eos_stop=False).result(timeout=600)
        deadline = time.monotonic() + 600
        while (engine.prefix_cache.host_blocks < 1
               and time.monotonic() < deadline):
            time.sleep(0.002)
        assert engine.prefix_cache.host_blocks >= 1, "eviction never spilled"
        spilled_hit = engine.submit(prompt_a, max_new_tokens=max_new,
                                    use_eos_stop=False).result(timeout=600)
        snap = engine.metrics.snapshot()
        assert snap["prefix_promotions_total"] >= 1, snap
        assert snap["prefix_hits"] >= 1
        engine.drain(timeout=60)
        assert engine.sanitizer_report == []
    finally:
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert spilled_hit.tokens == never_evicted.tokens
    assert spilled_hit.tokens == _reference(jc, jp, prompt_a, max_new)


# ---------------------------------------------------------------------------
# Chaos: swap faults lose nothing
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_swap_out_fault_keeps_device_copy(tiny):
    """host-swap-out armed: the demote fails before any state changes, the
    victim decodes on in place (no preemption) and both requests finish
    with their reference tokens, ledgers clean."""
    jc, jp, tc, tp = tiny
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        chaos().fail_io("host-swap-out", times=100)
        r_low, r_hi, low_p, hi_p, low_n, hi_n = _run_preemption(engine)
        assert engine.metrics.snapshot()["preemptions_total"] == 0, \
            "a demote fault must abort the preemption"
        assert engine.host_tier.host_used == 0
        engine.drain(timeout=120)
        assert engine.sanitizer_report == []
    finally:
        chaos().reset()
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert r_low.tokens == _reference(jc, jp, low_p, low_n)
    assert r_hi.tokens == _reference(jc, jp, hi_p, hi_n)


@pytest.mark.chaos
def test_chaos_swap_in_fault_refetches(tiny):
    """host-swap-in armed once: the first resume faults with the host copy
    intact, a later iteration re-fetches, and the resumed trajectory is
    still bitwise."""
    jc, jp, tc, tp = tiny
    engine = _engine(tc, tp, **_PREEMPT_KW).start()
    try:
        chaos().fail_io("host-swap-in", times=1)
        r_low, r_hi, low_p, hi_p, low_n, hi_n = _run_preemption(engine)
        snap = engine.metrics.snapshot()
        assert snap["preemptions_total"] >= 1
        assert snap["resumes_total"] >= 1
        engine.drain(timeout=120)
        assert engine.sanitizer_report == []
        assert engine.host_tier.host_used == 0
    finally:
        chaos().reset()
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert r_low.tokens == _reference(jc, jp, low_p, low_n)
    assert r_hi.tokens == _reference(jc, jp, hi_p, hi_n)


@pytest.mark.chaos
def test_chaos_prefix_spill_fault_drops_cleanly(tiny):
    """host-swap-out armed during prefix eviction: the spill fails before
    changing anything, the victim is dropped, and the next identical
    prompt re-prefills cold, correctly."""
    jc, jp, tc, tp = tiny
    prompt_a, prompt_b = _prompt(17, 31), _prompt(17, 32)
    engine = _engine(tc, tp, max_batch_size=2, prefix_cache_blocks=2,
                     host_kv_blocks=8, sanitize=True).start()
    try:
        engine.submit(prompt_a, max_new_tokens=6,
                      use_eos_stop=False).result(timeout=600)
        chaos().fail_io("host-swap-out", times=100)
        engine.submit(prompt_b, max_new_tokens=6,
                      use_eos_stop=False).result(timeout=600)
        assert engine.prefix_cache.host_blocks == 0
        chaos().reset()
        r = engine.submit(prompt_a, max_new_tokens=6,
                          use_eos_stop=False).result(timeout=600)
        assert engine.metrics.snapshot()["prefix_promotions_total"] == 0
        engine.drain(timeout=60)
        assert engine.sanitizer_report == []
    finally:
        chaos().reset()
        engine.shutdown()
    assert engine._scheduler_error is None, engine._scheduler_error
    assert r.tokens == _reference(jc, jp, prompt_a, 6)
