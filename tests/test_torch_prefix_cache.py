"""Automatic prefix caching in the port, against the JAX package's, on the
CPU: the radix trie over pool block ids (mirror of
``tests/serving/test_prefix_cache.py`` without the host-tier cases),
copy-on-write in the block pool, shared-block admission in the slots, and
the engine: a prefix hit commits the cold run's tokens bit for bit (fp32
and int8 pools), a pure hit copies nothing, greedy tokens equal the JAX
engine's with the cache on, and a default-configured server serves.

Config: the tiny preset (2 layers, vocab 64, fp32), JAX's weights carried
across with ``params_from_jax``; 4-token blocks (the engine derives them
from ``prefill_bucket=4``), so prompts of 9-13 tokens share 2-3 blocks.
Tokens compare exactly (greedy), logprobs to 1e-4 (fp32 through two
layers, sums in another order).
"""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation import generate_tokens
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops.quant import quantize_params as jquantize
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import MegatronServer
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.serving import (
    EngineConfig,
    ServingEngine,
    ServingMetrics,
)
from megatron_llm_tpu_torch.serving.block_pool import BlockPool, copy_block
from megatron_llm_tpu_torch.serving.prefix_cache import PrefixCache
from megatron_llm_tpu_torch.serving.slots import SlotAllocator
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

CFG = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8,
           fused_decode=False)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jtiny(**CFG), ttiny(**CFG)
    jp = jm.init_params(jax.random.key(0), jc)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


@pytest.fixture(scope="module")
def tiny_int8(tiny):
    jc, jp, tc, _ = tiny
    jc = dataclasses.replace(jc, kv_cache_quant="int8")
    tc = dataclasses.replace(tc, kv_cache_quant="int8")
    jq = jquantize(jp)
    return jc, jq, tc, params_from_jax(jax.tree.map(np.asarray, jq),
                                       device="cpu")


# ---------------------------------------------------------------------------
# Trie units (pool block ids, no engine)
# ---------------------------------------------------------------------------


def _mk_cache(cfg, *, block=4, budget=8, n_blocks=32, metrics=None):
    pool = BlockPool(cfg, n_blocks, block, device="cpu")
    return pool, PrefixCache(pool=pool, max_blocks=budget, metrics=metrics)


def _slot_table(pool, n):
    """An admitted slot: ``n`` blocks, one pool ref each."""
    assert pool.reserve(n)
    return [pool.alloc_reserved() for _ in range(n)]


def _retire(pool, table):
    """The slot lets go: only refs the trie took keep blocks alive."""
    for bid in table:
        pool.decref(bid)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_offer_match_is_zero_copy_ref_bump(tiny, quant):
    tc = dataclasses.replace(tiny[2], kv_cache_quant=quant)
    m = ServingMetrics()
    pool, cache = _mk_cache(tc, metrics=m)
    tokens = list(range(1, 11))      # 10 tokens: 2 full blocks of 4
    table = _slot_table(pool, 3)
    assert cache.offer(tokens, table) == 2
    assert cache.blocks == 2
    assert all(pool.ref(b) == 2 for b in table[:2])   # slot + trie
    _retire(pool, table)
    assert all(pool.ref(b) == 1 for b in table[:2])   # the trie keeps them
    assert pool.used_blocks == 2                      # boundary block freed
    lease = cache.match_and_acquire(tokens)
    assert lease is not None and lease.tokens == 8
    assert lease.bids == table[:2]
    assert pool.cow_copies == 0
    cache.release(lease)
    snap = m.snapshot()
    assert snap["prefix_hits"] == 1
    assert snap["prefix_hit_tokens"]["mean"] == 8.0


def test_match_is_strictly_shorter_than_prompt(tiny):
    pool, cache = _mk_cache(tiny[2])
    tokens = list(range(1, 9))       # exactly 2 blocks
    table = _slot_table(pool, 2)
    cache.offer(tokens, table)
    _retire(pool, table)
    lease = cache.match_and_acquire(tokens)
    assert lease is not None and lease.tokens == 4
    cache.release(lease)
    assert cache.match_and_acquire(tokens[:4]) is None


def test_match_miss_diverging_block(tiny):
    m = ServingMetrics()
    pool, cache = _mk_cache(tiny[2], metrics=m)
    table = _slot_table(pool, 2)
    cache.offer([1, 2, 3, 4, 5, 6, 7, 8], table)
    _retire(pool, table)
    assert cache.match_and_acquire([9, 9, 9, 9, 5, 6]) is None
    lease = cache.match_and_acquire([1, 2, 3, 4, 9, 9, 9, 9, 1])
    assert lease is not None and lease.tokens == 4
    cache.release(lease)
    assert m.snapshot()["prefix_misses"] == 1


def test_lru_eviction_under_budget_pressure(tiny):
    m = ServingMetrics()
    pool, cache = _mk_cache(tiny[2], budget=2, metrics=m)
    A, B, C = [10] * 5, [20 + i for i in range(5)], [30] * 5
    for toks in (A, B):
        t = _slot_table(pool, 2)
        cache.offer(toks, t)
        _retire(pool, t)
    cache.release(cache.match_and_acquire(A))   # touch A
    t = _slot_table(pool, 2)
    cache.offer(C, t)
    _retire(pool, t)
    assert cache.blocks == 2 and pool.used_blocks == 2
    assert cache.match_and_acquire(B) is None
    lease = cache.match_and_acquire(A)
    assert lease is not None
    cache.release(lease)
    assert cache.match_and_acquire(C) is not None
    assert m.snapshot()["prefix_evicted_blocks"] == 1


def test_ref_pinning_blocks_eviction_until_release(tiny):
    pool, cache = _mk_cache(tiny[2], budget=1)
    A, B = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10]
    t = _slot_table(pool, 2)
    cache.offer(A, t)
    _retire(pool, t)
    lease = cache.match_and_acquire(A)
    t = _slot_table(pool, 2)
    cache.offer(B, t)                           # over budget; A is pinned
    _retire(pool, t)
    assert cache.match_and_acquire(B) is None
    held = cache.match_and_acquire(A)
    assert held is not None
    cache.release(held)
    cache.release(lease)
    t = _slot_table(pool, 2)
    cache.offer(B, t)
    _retire(pool, t)
    assert cache.match_and_acquire(A) is None
    got = cache.match_and_acquire(B)
    assert got is not None
    cache.release(got)
    assert cache.blocks == 1 and pool.used_blocks == 1


def test_eviction_never_orphans_a_chain_middle(tiny):
    pool, cache = _mk_cache(tiny[2], budget=3)
    chain = list(range(1, 13))                  # 3 blocks
    t = _slot_table(pool, 3)
    cache.offer(chain, t)
    _retire(pool, t)
    lease = cache.match_and_acquire(chain + [99])
    assert lease is not None and lease.tokens == 12
    t = _slot_table(pool, 2)
    cache.offer([50] * 6, t)
    _retire(pool, t)
    assert cache.match_and_acquire([50] * 6) is None
    again = cache.match_and_acquire(chain + [99])
    assert again is not None and again.tokens == 12
    cache.release(again)
    cache.release(lease)


def test_forced_eviction_under_pool_pressure(tiny):
    pool, cache = _mk_cache(tiny[2], budget=8)
    A, B = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10]
    for toks in (A, B):
        t = _slot_table(pool, 2)
        cache.offer(toks, t)
        _retire(pool, t)
    lease = cache.match_and_acquire(A)
    assert cache.evict_blocks(2) == 1           # only B was evictable
    assert cache.match_and_acquire(B) is None
    again = cache.match_and_acquire(A + [0])
    assert again is not None
    cache.release(again)
    cache.release(lease)


# ---------------------------------------------------------------------------
# Copy-on-write and shared admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_copy_block_is_leafwise_and_exact(tiny, quant):
    tc = dataclasses.replace(tiny[2], kv_cache_quant=quant)
    k, _ = tm.init_kv_pool(tc, 4, 4, device="cpu")
    leaves = list(k.values()) if isinstance(k, dict) else [k]
    g = torch.Generator().manual_seed(0)
    for a in leaves:
        a.copy_(torch.randint(-100, 100, a.shape, generator=g).to(a.dtype))
    before = [a.clone() for a in leaves]
    copy_block(k, 1, 3)
    for a, b in zip(leaves, before):
        assert torch.equal(a[:, 3], b[:, 1])
        assert torch.equal(a[:, :3], b[:, :3])


def test_ensure_writable_copies_shared_blocks(tiny):
    cows = []
    pool = BlockPool(tiny[2], 6, 4, device="cpu",
                     on_cow=lambda: cows.append(1))
    assert pool.reserve(3)
    bid = pool.alloc_reserved()
    pool.k_pool[:, bid] = 7.0
    assert pool.ensure_writable(bid) == bid      # sole owner: in place
    pool.incref(bid)                             # now shared
    new = pool.ensure_writable(bid)
    assert new != bid and pool.ref(bid) == 1 and pool.ref(new) == 1
    assert torch.equal(pool.k_pool[:, new], pool.k_pool[:, bid])
    assert pool.cow_copies == 1 and cows == [1]
    fresh = pool.ensure_writable(BlockPool.TRASH)  # trash: a new block
    assert fresh not in (bid, new, BlockPool.TRASH)
    assert pool.cow_copies == 1


def test_insert_shares_blocks_and_appends_copy_on_write(tiny):
    tc = tiny[2]
    pool = BlockPool(tc, 16, 4, device="cpu")
    slots = SlotAllocator(tc, 2, 16, pool)
    assert pool.reserve(2)
    shared = [pool.alloc_reserved() for _ in range(2)]
    pool.k_pool[:, shared[0]] = 3.0
    k, v = tm.init_kv_cache(tc, 1, slots.width, device="cpu")
    k.fill_(5.0)
    slot = slots.alloc()
    assert pool.reserve(2)
    slots.set_reservation(slot, 2)
    slots.insert(slot, k, v, 10, shared_bids=shared)
    assert list(slots.tables[slot][:2]) == shared
    assert all(pool.ref(b) == 2 for b in shared)
    assert bool((pool.k_pool[:, shared[0]] == 3.0).all())  # not scattered
    assert bool((pool.k_pool[:, slots.tables[slot][2]] == 5.0).all())
    # appending into a shared block copies it first
    bid = slots.append_block_id(slot, 5)
    assert bid != shared[1] and pool.cow_copies == 1
    assert pool.ref(shared[1]) == 1


# ---------------------------------------------------------------------------
# Engine: a hit equals a cold run
# ---------------------------------------------------------------------------


def _engine(tc, tp, **overrides):
    kw = dict(max_batch_size=2, max_seq_len=64, max_queue_size=8,
              prefill_bucket=4, prefix_cache_blocks=32)
    kw.update(overrides)
    return ServingEngine(tc, tp, EngineConfig(**kw), device="cpu")


def _reference(jc, jp, prompt, max_new):
    total = len(prompt) + max_new
    toks = np.zeros((1, total), np.int32)
    toks[0, :len(prompt)] = prompt
    out = generate_tokens(jc, jp, jnp.asarray(toks),
                          jnp.asarray([len(prompt)], jnp.int32),
                          eos_id=-1, use_eos_stop=False)
    return np.asarray(out.tokens)[0].tolist()


def _run_seq(engine, specs):
    """One request at a time: each retires (offering its prefix) before
    the next is admitted."""
    try:
        return [engine.submit(p, max_new_tokens=n,
                              use_eos_stop=False).result(timeout=600).tokens
                for p, n in specs]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("fixture", ["tiny", "tiny_int8"])
def test_prefix_hit_bitwise_equals_cold(fixture, request):
    jc, jp, tc, tp = request.getfixturevalue(fixture)
    rng = np.random.default_rng(11)
    prompt = rng.integers(1, tc.vocab_size, 11).tolist()
    fork = prompt[:8] + rng.integers(1, tc.vocab_size, 5).tolist()
    engine = _engine(tc, tp).start()
    got = _run_seq(engine, [(prompt, 8), (prompt, 8), (fork, 8)])
    assert got[0] == _reference(jc, jp, prompt, 8)
    assert got[1] == got[0]
    assert got[2] == _reference(jc, jp, fork, 8)
    snap = engine.metrics.snapshot()
    assert snap["prefix_hits"] == 2 and snap["prefix_misses"] == 1
    assert snap["prefix_hit_tokens"]["mean"] == 8.0
    assert snap["prefix_blocks"] > 0


# the engine's cached prefill against a one-pass prefill of the whole
# prompt (the JAX engine's cold path): the last piece attends the stored
# prefix rows through the masked dense path where the one pass attends
# its window causally, fp32 sums in another order (measured ~6e-8 here);
# with an int8 pool it attends the stored int8 rows where the one pass
# attends its own fp32 ones (measured ~3e-4)
ONE_PASS_TOL = {"tiny": dict(rtol=0, atol=1e-6),
                "tiny_int8": dict(rtol=0, atol=2e-3)}


@pytest.mark.parametrize("fixture", ["tiny", "tiny_int8"])
def test_prefix_hit_prefill_equals_cold_bitwise(fixture, request):
    """Below the tokens: a repeat's prefill (the lease's rows gathered,
    the last piece at the split) gives the cold admission's first-token
    logits and rows bit for bit, and both are a one-pass prefill's to
    the stated tolerance."""
    _, _, tc, tp = request.getfixturevalue(fixture)
    rng = np.random.default_rng(12)
    prompt = rng.integers(1, tc.vocab_size, 11).tolist()
    engine = _engine(tc, tp).start()
    try:
        engine.submit(prompt, 2, use_eos_stop=False).result(600)
        engine.pause()
        deadline = time.monotonic() + 60
        while engine._inflight is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine._inflight is None and not engine._active
        from megatron_llm_tpu_torch.serving.engine import _Request
        req = _Request(prompt, 2, use_eos_stop=False)
        lease = engine.prefix_cache.match_and_acquire(prompt)
        assert lease is not None and lease.tokens == 8
        hit_logits, hk, hv = engine._prefill_cached(req, lease)
        cold_logits, ck, cv = engine._prefill_cached(req, None)
        toks = np.zeros((1, 12), np.int64)
        toks[0, :11] = prompt
        one_logits, _, _, _ = engine._prefill(toks, 11, False)
        engine.prefix_cache.release(lease)
    finally:
        engine.shutdown()
    assert torch.equal(hit_logits, cold_logits)
    for h, c in ((hk, ck), (hv, cv)):
        for leaf in (("q", "scale") if isinstance(h, dict) else (None,)):
            hl, cl = (h[leaf], c[leaf]) if leaf else (h, c)
            assert torch.equal(hl[:, :, :, :11], cl[:, :, :, :11])
    np.testing.assert_allclose(cold_logits.numpy(), one_logits.numpy(),
                               **ONE_PASS_TOL[fixture])


def test_pure_hit_admission_performs_zero_copies(tiny):
    jc, jp, tc, tp = tiny
    prompt = np.random.default_rng(16).integers(1, tc.vocab_size,
                                                13).tolist()
    engine = _engine(tc, tp).start()
    got = _run_seq(engine, [(prompt, 6)] * 3)
    assert got == [_reference(jc, jp, prompt, 6)] * 3
    snap = engine.metrics.snapshot()
    assert snap["prefix_hits"] == 2
    assert snap["cow_copies_total"] == 0
    assert snap["blocks_used"] > 0
    assert 0.0 < snap["kv_cache_util"] <= 1.0


def test_prefix_cache_disabled(tiny):
    jc, jp, tc, tp = tiny
    prompt = np.random.default_rng(13).integers(1, tc.vocab_size,
                                                11).tolist()
    engine = _engine(tc, tp, prefix_cache_blocks=0).start()
    got = _run_seq(engine, [(prompt, 6), (prompt, 6)])
    assert engine.prefix_cache is None
    assert got == [_reference(jc, jp, prompt, 6)] * 2
    snap = engine.metrics.snapshot()
    assert snap["prefix_hits"] == 0 and snap["prefix_misses"] == 0


def test_logprob_requests_bypass_the_cache(tiny):
    _, _, tc, tp = tiny
    prompt = np.random.default_rng(14).integers(1, tc.vocab_size,
                                                9).tolist()
    engine = _engine(tc, tp).start()
    try:
        a, b = (engine.submit(prompt, max_new_tokens=4, use_eos_stop=False,
                              return_logprobs=True).result(timeout=600)
                for _ in range(2))
    finally:
        engine.shutdown()
    assert a.tokens == b.tokens
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    snap = engine.metrics.snapshot()
    assert snap["prefix_hits"] == 0 and snap["prefix_misses"] == 0


def test_pinned_blocks_survive_a_concurrent_eviction_storm(tiny):
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(15)
    shared = rng.integers(1, tc.vocab_size, 9).tolist()
    engine = _engine(tc, tp, prefix_cache_blocks=2).start()
    try:
        first = engine.submit(shared, max_new_tokens=12, use_eos_stop=False)
        storm = [engine.submit(rng.integers(1, tc.vocab_size, 9).tolist(),
                               max_new_tokens=2, use_eos_stop=False)
                 for _ in range(6)]
        for h in storm:
            h.result(timeout=600)
        a = first.result(timeout=600)
        b = engine.submit(shared, max_new_tokens=12,
                          use_eos_stop=False).result(timeout=600)
    finally:
        engine.shutdown()
    ref = _reference(jc, jp, shared, 12)
    assert a.tokens == ref and b.tokens == ref
    assert engine.metrics.snapshot()["prefix_evicted_blocks"] > 0
    assert engine.prefix_cache.blocks <= 2 + 2


def test_pool_pressure_squeezes_the_cache(tiny):
    """A pool with room for one request besides the cached prefix: the
    next admission evicts unpinned cache blocks instead of parking."""
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(17)
    a = rng.integers(1, tc.vocab_size, 13).tolist()
    b = rng.integers(1, tc.vocab_size, 13).tolist()
    # a request needs ceil((13 + 6) / 4) = 5 blocks; the pool has 6
    engine = _engine(tc, tp, kv_pool_blocks=7, max_batch_size=1).start()
    got = _run_seq(engine, [(a, 6), (b, 6)])
    assert got == [_reference(jc, jp, a, 6), _reference(jc, jp, b, 6)]
    snap = engine.metrics.snapshot()
    assert snap["prefix_evicted_blocks"] > 0


@pytest.mark.parametrize("fixture", ["tiny", "tiny_int8"])
def test_engine_tokens_match_jax_with_cache(fixture, request):
    """Concurrent requests sharing prefixes, both engines with the cache
    on (the default 256 blocks): the same greedy tokens, the same hits."""
    jc, jp, tc, tp = request.getfixturevalue(fixture)
    rng = np.random.default_rng(18)
    base = rng.integers(1, tc.vocab_size, 12).tolist()
    prompts = [base + rng.integers(1, tc.vocab_size, n).tolist()
               for n in (1, 5, 3)] + [base[:9]]
    news = (6, 4, 7, 5)
    kw = dict(max_batch_size=2, max_seq_len=64, prefill_bucket=4)

    def run(engine):
        engine.start()
        try:
            first = engine.submit(base, 3, use_eos_stop=False).result(600)
            hs = [engine.submit(p, n, use_eos_stop=False)
                  for p, n in zip(prompts, news)]
            return [first.tokens] + [h.result(600).tokens for h in hs], \
                engine.metrics.snapshot()
        finally:
            engine.shutdown()

    want, jsnap = run(JServingEngine(jc, jp, JEngineConfig(**kw)))
    got, tsnap = run(ServingEngine(tc, tp, EngineConfig(**kw), device="cpu"))
    assert got == want
    assert tsnap["prefix_hits"] == jsnap["prefix_hits"] > 0
    assert tsnap["prefix_misses"] == jsnap["prefix_misses"]


# ---------------------------------------------------------------------------
# A default-configured server
# ---------------------------------------------------------------------------


def _put(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api",
                                 data=json.dumps(body).encode(),
                                 method="PUT")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_default_server_serves(tiny):
    """``MegatronServer(cfg, params, tokenizer)`` with no engine options:
    the prefix cache and span tracing on, PUT /api answers 200 with the
    JAX engine's greedy tokens, and a repeat hits the cache."""
    jc, jp, tc, tp = tiny
    server = MegatronServer(tc, tp, NullTokenizer(tc.vocab_size),
                            device="cpu")
    server.run("127.0.0.1", 0, block=False)
    try:
        ec = server.service.engine.config
        assert (ec.prefix_cache_blocks, ec.trace) == (256, True)
        prompt = " ".join(str(t) for t in range(3, 12))
        body = {"prompts": [prompt], "tokens_to_generate": 5,
                "no_early_termination": True}
        status, out = _put(server.port, body)
        assert status == 200
        again = _put(server.port, body)
        assert again == (200, {**out, "request_ids": again[1]["request_ids"]})
        snap = server.service.metrics_snapshot()
        assert snap["prefix_hits"] == 1
    finally:
        server.shutdown()
    want = _reference(jc, jp, list(range(3, 12)), 5)
    assert [int(t) for t in out["text"][0].split()] == want


@pytest.mark.parametrize("kw", [dict(host_kv_blocks=4),
                                dict(prefill_chunk=8)],
                         ids=["host_kv_blocks", "prefill_chunk"])
def test_unported_option_answers_501(tiny, kw):
    """A server with ``host_kv_blocks`` or ``prefill_chunk`` answers 200
    with the greedy tokens of JAX's reference."""
    jc, jp, tc, tp = tiny
    server = MegatronServer(tc, tp, NullTokenizer(tc.vocab_size),
                            device="cpu", **kw)
    server.run("127.0.0.1", 0, block=False)
    try:
        status, out = _put(server.port, {"prompts": ["1 2 3"],
                                         "tokens_to_generate": 2,
                                         "no_early_termination": True})
    finally:
        server.shutdown()
    assert status == 200
    assert [int(t) for t in out["text"][0].split()] == \
        _reference(jc, jp, [1, 2, 3], 2)
