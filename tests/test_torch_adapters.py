"""Multi-tenant LoRA serving in the port's engine (mirror of
``tests/serving/test_adapters.py``), on the CPU.

The invariant: every token of a mixed-adapter decode batch equals, bit for
bit, the same request run alone on the same engine, across fp32/int8/int4
weights, paged and one-block ("dense") KV layouts and speculation on or
off, on the fused route (the kernels' plain versions here) and the
composed route.  Plus the registry's residency (LRU with pinning, an
eviction storm), refusals, ``swap_params``, the prefix cache left to base
requests, a resident draft under adapters, and the port engine's greedy
tokens against the JAX engine's on the same weights and adapters.

Model: Llama-style, hidden 256, head dim 128 (2 heads), 2 layers, ffn 512,
vocab 128, fp32 (the fused predicates take it), JAX's random weights
carried across.  Adapters: JAX's ``init_lora_adapter`` (rank 16, α 32,
every target) with a non-zero B from ``jax.random`` x 0.05, crossing as
numpy; 2 arena slots (Sr 32).  JAX's ``test_no_recompiles_as_adapters_
rotate`` has no torch counterpart (nothing compiles); in its place an
install is shown to write into the same arena storage.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.ops import lora as jl
from megatron_llm_tpu.serving import AdapterRegistry as JAdapterRegistry
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import adapter_from_jax, params_from_jax
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.models.families import draft_model
from megatron_llm_tpu_torch.ops import lora as tl
from megatron_llm_tpu_torch.ops.quant import quantize_params
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving.adapters import AdapterRegistry

torch.set_num_threads(1)

PROMPT = [3, 5, 7, 11, 13]
# repetitive, so the n-gram drafter engages in the spec variants
REP_PROMPT = [5, 9, 3, 5, 9, 3, 5, 9, 3, 5, 9]
RANK, N_SLOTS = 16, 2
TARGETS = tl.LORA_TARGETS


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=2, num_attention_heads=2,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=96, max_position_embeddings=96,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


def _jax_adapter(cfg, seed, rank=RANK, targets=TARGETS):
    ad = jl.init_lora_adapter(cfg, jax.random.key(seed), rank, alpha=32.0,
                              targets=targets)
    return dataclasses.replace(ad, factors={
        t: {"a": f["a"],
            "b": jax.random.normal(jax.random.key(seed + 500),
                                   f["b"].shape, f["b"].dtype) * 0.05}
        for t, f in ad.factors.items()})


def _port_adapter(jad):
    return adapter_from_jax({"rank": jad.rank, "alpha": jad.alpha,
                             "targets": jad.targets,
                             "factors": jax.tree.map(np.asarray,
                                                     jad.factors)},
                            device="cpu")


@pytest.fixture(scope="module")
def models():
    jc = jllama2("7b", **_kw())
    jp = jmodel.init_params(jax.random.key(0), jc)
    jads = [_jax_adapter(jc, 100 + i) for i in range(4)]
    return dict(jc=jc, jp=jp, jads=jads, tc=tllama2("7b", **_kw()),
                tp=params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"),
                ads=[_port_adapter(a) for a in jads])


def _registry(m, n_adapters=3, n_slots=N_SLOTS, cfg=None):
    reg = AdapterRegistry(cfg or m["tc"], n_slots, RANK, TARGETS,
                          device="cpu")
    for i in range(n_adapters):
        reg.register(f"t{i}", m["ads"][i])
    return reg


def _engine(m, reg, params=None, cfg=None, **kw):
    ec = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16,
              idle_wait_s=0.005, adapter_cache_slots=reg.n_slots,
              prefix_cache_blocks=0)
    ec.update(kw)
    return ServingEngine(cfg or m["tc"], m["tp"] if params is None
                         else params, EngineConfig(**ec), adapters=reg,
                         device="cpu")


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_register_validates(self, models):
        reg = AdapterRegistry(models["tc"], 2, RANK, TARGETS, device="cpu")
        with pytest.raises(ValueError, match="rank"):
            reg.register("r8", _port_adapter(_jax_adapter(models["jc"], 1,
                                                          rank=8)))
        with pytest.raises(ValueError, match="targets"):
            reg.register("q", _port_adapter(_jax_adapter(
                models["jc"], 1, targets=("wq",))))
        reg.register("a", models["ads"][0])
        assert reg.known("a") and not reg.known("b")
        with pytest.raises(KeyError):
            reg.acquire("never-registered")

    def test_lru_eviction_and_ref_pinning(self, models):
        reg = _registry(models, n_adapters=4)
        s0, s1 = reg.acquire("t0"), reg.acquire("t1")
        assert {s0, s1} == {0, 1}
        assert reg.acquire("t2") is None        # both pinned: no victim
        reg.release("t0")
        s2 = reg.acquire("t2")
        assert s2 == s0 and not reg.is_resident("t0")
        assert reg.is_resident("t1")
        assert reg.acquire("t1") == s1          # a hit, not an install
        reg.release("t1")
        reg.release("t1")
        reg.release("t2")
        assert all(reg.pins(a) == 0 for a in reg.resident())
        assert reg.resident_bytes() == 2 * models["ads"][0].nbytes

    def test_resident_adapter_cannot_be_replaced(self, models):
        reg = _registry(models, n_adapters=2, n_slots=1)
        reg.acquire("t0")
        with pytest.raises(ValueError, match="resident"):
            reg.register("t0", models["ads"][3])
        reg.release("t0")
        with pytest.raises(ValueError, match="resident"):
            reg.register("t0", models["ads"][3])
        reg.acquire("t1")                       # evicts the parked t0
        reg.register("t0", models["ads"][3])
        reg.release("t1")

    def test_clone_shares_store_not_residency(self, models):
        reg = _registry(models, n_adapters=2)
        reg.acquire("t0")
        twin = reg.clone()
        assert twin.known("t0") and twin.known("t1")
        assert not twin.is_resident("t0") and reg.is_resident("t0")
        assert twin.arenas["wq"]["a"].data_ptr() != \
            reg.arenas["wq"]["a"].data_ptr()
        twin.register("t9", models["ads"][3])
        assert not reg.known("t9")
        reg.release("t0")

    def test_install_writes_the_arena_in_place(self, models):
        """Adapters rotating through the slots (installs, evictions)
        write into the same arena tensors: the storage never moves, so a
        step never sees a new operand (the JAX test's no-recompile
        guarantee).  The installed columns are the adapter's, α/r folded
        into B."""
        reg = _registry(models, n_adapters=4)
        ptrs = {t: (f["a"].data_ptr(), f["b"].data_ptr())
                for t, f in reg.arenas.items()}
        for aid in ("t0", "t1", "t2", "t3", "t0"):
            slot = reg.acquire(aid)
            reg.release(aid)
            ad = models["ads"][int(aid[1])]
            cols = slice(slot * RANK, (slot + 1) * RANK)
            assert torch.equal(reg.arenas["wv"]["a"][:, :, cols],
                               ad.factors["wv"]["a"])
            torch.testing.assert_close(reg.arenas["wo"]["b"][:, cols],
                                       ad.factors["wo"]["b"] * ad.scale,
                                       rtol=0, atol=0)
        assert ptrs == {t: (f["a"].data_ptr(), f["b"].data_ptr())
                        for t, f in reg.arenas.items()}

    def test_moe_mlp_targets_refused(self, models):
        moe = tllama2("7b", **_kw(num_experts=4))
        with pytest.raises(ValueError, match="MoE"):
            AdapterRegistry(moe, 2, RANK, ("wq", "w_up"), device="cpu")


def test_engine_needs_a_matching_registry(models):
    """``adapter_cache_slots`` without a registry, a registry of another
    slot count, or an arena on another device raise ValueError."""
    tc, tp = models["tc"], models["tp"]
    with pytest.raises(ValueError, match="AdapterRegistry"):
        ServingEngine(tc, tp, EngineConfig(max_seq_len=64,
                                           adapter_cache_slots=2),
                      device="cpu")
    reg = _registry(models, n_slots=3)
    with pytest.raises(ValueError, match="adapter_cache_slots"):
        ServingEngine(tc, tp, EngineConfig(max_seq_len=64,
                                           adapter_cache_slots=2),
                      adapters=reg, device="cpu")
    meta = AdapterRegistry(tc, 2, RANK, TARGETS, device="meta")
    with pytest.raises(ValueError, match="arena is on meta"):
        ServingEngine(tc, tp, EngineConfig(max_seq_len=64,
                                           adapter_cache_slots=2),
                      adapters=meta, device="cpu")


# ---------------------------------------------------------------------------
# Mixed == alone, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized(models):
    tp = models["tp"]
    return {"fp32": tp, "int8": quantize_params(tp, "int8"),
            "int4": quantize_params(tp, "int4")}


def _drive(m, params, spec, cfg=None, **overrides):
    kw = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16)
    if spec:
        kw["spec_draft_len"] = 3
    kw.update(overrides)
    reg = _registry(m, n_adapters=2)
    prompt = REP_PROMPT if spec else PROMPT
    max_new = 16 if spec else 8
    specs = [dict(adapter_id="t0"), dict(), dict(adapter_id="t1"),
             dict(adapter_id="t0")]
    engine = _engine(m, reg, params, cfg, **kw).start()
    try:
        alone = [engine.submit(prompt, max_new, use_eos_stop=False,
                               **s).result(600).tokens for s in specs]
        handles = [engine.submit(prompt, max_new, use_eos_stop=False, **s)
                   for s in specs]
        mixed = [h.result(600).tokens for h in handles]
        snap = engine.metrics.snapshot()
    finally:
        engine.shutdown()
    assert mixed == alone
    assert alone[0] != alone[1] and alone[2] != alone[1]
    assert alone[2] != alone[0]
    assert alone[3] == alone[0]
    assert snap["max_decode_batch"] >= 2
    if spec:
        assert snap["spec_steps"] > 0, "drafter never engaged"
    assert all(reg.pins(a) == 0 for a in reg.resident())
    return engine, snap


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("precision", ["fp32", "int8", "int4"])
def test_mixed_batch_matrix(models, quantized, precision, layout, spec):
    """On the fused route: mixed == alone, and every decode step fused."""
    block = 16 if layout == "paged" else 64
    engine, snap = _drive(models, quantized[precision], spec,
                          kv_block_size=block)
    assert engine._fused_decode and (engine._fused_verify or not spec)
    assert sum(r["fallback"] for r in snap["step_routes"].values()) == 0


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_mixed_batch_composed_route(models, spec):
    """``fused_decode=False``: the composed route applies the adapters,
    and mixed == alone holds there too."""
    cfg = dataclasses.replace(models["tc"], fused_decode=False)
    engine, snap = _drive(models, models["tp"], spec, cfg=cfg,
                          kv_block_size=16)
    assert not engine._fused_decode
    assert sum(r["fused"] for r in snap["step_routes"].values()) == 0


def test_arena_off_the_kernels_tiles_takes_the_composed_route(models):
    """A stacked rank the kernel does not take (2 slots x rank 3) makes
    the predicates decline: the engine decodes on the composed route with
    the adapters applied, never dropping them."""
    reg = AdapterRegistry(models["tc"], 2, 3, ("wq", "wv"), device="cpu")
    for i in range(2):
        reg.register(f"t{i}", _port_adapter(_jax_adapter(
            models["jc"], 300 + i, rank=3, targets=("wq", "wv"))))
    engine = _engine(models, reg, kv_block_size=16).start()
    try:
        base = engine.submit(PROMPT, 8, use_eos_stop=False).result(600)
        t0 = engine.submit(PROMPT, 8, use_eos_stop=False,
                           adapter_id="t0").result(600)
    finally:
        engine.shutdown()
    assert not engine._fused_decode
    assert base.tokens != t0.tokens


def test_eviction_storm_ref_pinning(models):
    """8 requests over 4 adapters through a 2-slot arena: admission parks
    when every slot is pinned, evictions rotate adapters in as pins drop,
    every stream equals its alone run, pins return to 0 and the block
    ledger balances."""
    reg = _registry(models, n_adapters=4)
    engine = _engine(models, reg, max_batch_size=2, max_queue_size=32,
                     kv_block_size=16).start()
    try:
        ids = [f"t{(i // 2) % 4}" for i in range(8)]
        alone = {aid: engine.submit(PROMPT, 8, use_eos_stop=False,
                                    adapter_id=aid).result(600).tokens
                 for aid in sorted(set(ids))}
        handles = [engine.submit(PROMPT, 8, use_eos_stop=False,
                                 adapter_id=aid) for aid in ids]
        results = [h.result(600).tokens for h in handles]
        snap = engine.metrics.snapshot()
        pool = engine.slots.pool
    finally:
        engine.shutdown()
    for aid, toks in zip(ids, results):
        assert toks == alone[aid]
    assert snap["adapter_evictions"] > 0 and snap["adapter_hits"] > 0
    assert snap["adapter_installs"] >= 4
    assert snap["adapter_resident"] == 2
    assert snap["adapter_resident_bytes"] == 2 * models["ads"][0].nbytes
    assert 0.0 < snap["adapter_hit_rate"] < 1.0
    assert all(reg.pins(a) == 0 for a in reg.resident())
    assert pool.reserved_blocks == 0
    assert pool.free_blocks == pool.usable_blocks


def test_unknown_adapter_rejected_at_submit(models):
    reg = _registry(models, n_adapters=1)
    engine = _engine(models, reg).start()
    try:
        with pytest.raises(ValueError, match="unknown adapter"):
            engine.submit(PROMPT, 4, adapter_id="never-registered")
    finally:
        engine.shutdown()
    assert engine.metrics.snapshot()["rejected_invalid"] == 1
    bare = ServingEngine(models["tc"], models["tp"], EngineConfig(
        max_batch_size=2, max_seq_len=64), device="cpu").start()
    try:
        with pytest.raises(ValueError, match="adapter"):
            bare.submit(PROMPT, 4, adapter_id="t0")
    finally:
        bare.shutdown()


# ---------------------------------------------------------------------------
# Live weight swap
# ---------------------------------------------------------------------------


def test_swap_params_mid_traffic_loses_no_tokens(models):
    """``swap_params`` fences at an iteration boundary: a stream keeps
    decoding across it, every token arrives exactly once, the old tree
    comes back, and the arena is untouched."""
    reg = _registry(models, n_adapters=1)
    engine = _engine(models, reg, max_batch_size=2, max_seq_len=96).start()
    params2 = tmodel.init_params(models["tc"], seed=99, device="cpu")
    got = []
    try:
        h = engine.submit(PROMPT, 48, use_eos_stop=False, adapter_id="t0",
                          on_token=got.append)
        time.sleep(0.05)
        old = engine.swap_params(params2)
        r = h.result(600)
    finally:
        engine.shutdown()
    assert old is models["tp"] and engine.params is params2
    gen = r.tokens[len(PROMPT):]
    assert len(gen) == 48 and got == gen
    assert engine.metrics.snapshot()["param_swaps"] == 1
    slot = reg.resident()["t0"]
    assert torch.equal(reg.arenas["wq"]["a"][:, :, slot * RANK:
                                            (slot + 1) * RANK],
                       models["ads"][0].factors["wq"]["a"])


def test_swap_params_rejects_mismatched_tree(models):
    engine = ServingEngine(models["tc"], models["tp"], EngineConfig(
        max_batch_size=2, max_seq_len=64), device="cpu").start()
    bad = tllama2("7b", **_kw(num_layers=1))
    try:
        with pytest.raises(ValueError, match="structure|shape"):
            engine.swap_params(tmodel.init_params(bad, device="cpu"))
        with pytest.raises(ValueError, match="structure|shape"):
            engine.swap_params(quantize_params(models["tp"], "int8"))
        r = engine.submit(PROMPT, 4, use_eos_stop=False).result(600)
        assert len(r.tokens) == len(PROMPT) + 4
    finally:
        engine.shutdown()


# ---------------------------------------------------------------------------
# Against the JAX engine; the prefix cache; a resident draft
# ---------------------------------------------------------------------------


def _mixed_requests():
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, 128, n).tolist() for n in (3, 17, 30, 9, 12)]
    return prompts, [10, 7, 9, 5, 8], ["t0", None, "t1", "t2", "t0"]


@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec"])
def test_greedy_tokens_match_the_jax_engine(models, spec):
    """The port engine (fused route, plain versions) and the JAX engine
    (composed off a TPU), both at the default prefix cache, serve the same
    five requests under three adapters and the base model through a
    2-slot arena: the same greedy tokens."""
    prompts, news, ids = _mixed_requests()
    kw = dict(max_batch_size=4, max_seq_len=64, max_queue_size=16,
              kv_block_size=16, prefill_bucket=8, adapter_cache_slots=2,
              spec_draft_len=spec)
    jreg = JAdapterRegistry(models["jc"], 2, RANK, TARGETS)
    for i in range(3):
        jreg.register(f"t{i}", models["jads"][i])
    jeng = JServingEngine(models["jc"], models["jp"], JEngineConfig(**kw),
                          adapters=jreg).start()
    try:
        hs = [jeng.submit(p, n, use_eos_stop=False, adapter_id=a)
              for p, n, a in zip(prompts, news, ids)]
        want = [h.result(600).tokens for h in hs]
    finally:
        jeng.shutdown()
    reg = _registry(models, n_adapters=3)
    eng = ServingEngine(models["tc"], models["tp"], EngineConfig(**kw),
                        adapters=reg, device="cpu").start()
    try:
        hs = [eng.submit(p, n, use_eos_stop=False, adapter_id=a)
              for p, n, a in zip(prompts, news, ids)]
        got = [h.result(600).tokens for h in hs]
    finally:
        eng.shutdown()
    assert eng._fused_decode
    assert got == want


def test_adapter_requests_skip_the_prefix_cache(models):
    """With the prefix cache on, an adapter request neither hits nor seeds
    it: a repeated adapter prompt misses, while a repeated base prompt
    hits."""
    reg = _registry(models, n_adapters=1)
    engine = _engine(models, reg, kv_block_size=16,
                     prefix_cache_blocks=32).start()
    prompt = list(range(3, 40))
    try:
        a1 = engine.submit(prompt, 4, use_eos_stop=False,
                           adapter_id="t0").result(600)
        a2 = engine.submit(prompt, 4, use_eos_stop=False,
                           adapter_id="t0").result(600)
        snap_a = engine.metrics.snapshot()
        b1 = engine.submit(prompt, 4, use_eos_stop=False).result(600)
        b2 = engine.submit(prompt, 4, use_eos_stop=False).result(600)
        snap_b = engine.metrics.snapshot()
    finally:
        engine.shutdown()
    assert a1.tokens == a2.tokens and b1.tokens == b2.tokens
    assert a1.tokens != b1.tokens
    assert snap_a["prefix_hits"] == 0 and snap_a["prefix_blocks"] == 0
    assert snap_b["prefix_hits"] == 1


def test_resident_draft_under_adapters_keeps_the_tokens(models):
    """With a ``tiny`` resident draft (``spec_draft_len=3``), adapter and
    base requests commit the tokens they commit without speculation: the
    draft proposes under the base model, the target verifies under each
    requester's adapter (K14's tree mode's plain version)."""
    prompts, news, ids = _mixed_requests()
    td = draft_model("tiny", models["tc"])
    dparams = tmodel.init_params(td, seed=1, device="cpu")
    out = {}
    for spec in (0, 3):
        reg = _registry(models, n_adapters=3)
        eng = ServingEngine(
            models["tc"], models["tp"], EngineConfig(
                max_batch_size=4, max_seq_len=64, max_queue_size=16,
                kv_block_size=16, prefill_bucket=8, adapter_cache_slots=2,
                spec_draft_len=spec),
            draft_cfg=td, draft_params=dparams, adapters=reg,
            device="cpu").start()
        try:
            hs = [eng.submit(p, n, use_eos_stop=False, adapter_id=a)
                  for p, n, a in zip(prompts, news, ids)]
            out[spec] = [h.result(600).tokens for h in hs]
            snap = eng.metrics.snapshot()
        finally:
            eng.shutdown()
        if spec:
            assert snap["spec_by_source"]["model"]["steps"] > 0
    assert out[3] == out[0]
