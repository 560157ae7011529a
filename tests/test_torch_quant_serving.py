"""Quantized serving in the port against the JAX package, fp32 on the CPU:
an int8 KV cache (``kv_cache_quant="int8"``) under each weight precision
policy, through ``forward_cached``, ``forward_cached_paged``, the
``ServingEngine`` and GET /metrics.

Both sides get the same weights: the JAX init quantized by the JAX
``quantize_params`` and carried across with ``params_from_jax`` (the
codes and scales cross bit for bit).  Tiny configs: the llama one (GQA, 4
query heads over 2) and an MQA one (one KV head).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops import quant as jq
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import MegatronServer
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.ops import quant as tq
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

# fp32 end to end on both sides: two layers whose sums run in another
# order; the int8 cache codes round the same K/V on both sides
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {"gqa": {}, "mqa": dict(num_kv_heads=1)}
# the presets, and int4 at group 32 so the tiny 64-row inputs take int4
# (at the presets' group 128 they fall back to int8)
POLICIES = {"none": None, "int8": "int8", "mixed": "mixed",
            "int4-g32": ("int4", "int4", "int8", 32)}


# JAX's functions jitted once a config (eager, each op compiles alone)
_jfc = jax.jit(jm.forward_cached, static_argnums=0,
               static_argnames="empty_cache")
_jfcp = jax.jit(jm.forward_cached_paged, static_argnums=0)
_jscatter = jax.jit(jm.cache_scatter_blocks)


def _pair(cfg_name, policy, seed=0):
    kw = dict(kv_cache_quant="int8", fused_decode=False, **CONFIGS[cfg_name])
    jc, tc = jtiny(**kw), ttiny(**kw)
    jp = jm.init_params(jax.random.key(seed), jc)
    pol = POLICIES[policy]
    if pol is not None:
        jp = jq.quantize_params(jp, pol if isinstance(pol, str)
                                else jq.PrecisionPolicy(*pol))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_forward_cached_int8_cache_matches_jax(cfg_name, policy):
    """A prefill over the fresh K/V, then decode steps over the int8 cache
    at per-row fills, step for step."""
    jc, jp, tc, tp = _pair(cfg_name, policy)
    if policy != "none":
        assert tq.precision_route(tp) == jq.precision_route(jp)
    b, plen, max_len, steps = 2, 9, 32, 4
    toks = _tokens(b, plen + steps, jc.vocab_size, seed=1)
    jk, jv = jm.init_kv_cache(jc, b, max_len)
    tk, tv = tm.init_kv_cache(tc, b, max_len, device="cpu")
    assert tk["q"].dtype == torch.int8 and tk["scale"].shape == (
        tc.num_layers, b, tc.kv_heads, max_len)
    want, jk, jv = _jfc(jc, jp, jnp.asarray(toks[:, :plen]), jk,
                                     jv, jnp.int32(0), empty_cache=True)
    got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(toks[:, :plen]),
                                    tk, tv, 0, empty_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk["scale"].numpy(), np.asarray(jk["scale"]),
                               **TOL)
    for i in range(steps):
        fills = np.full((b,), plen + i, np.int32)
        step = toks[:, plen + i:plen + i + 1]
        want, jk, jv = _jfc(jc, jp, jnp.asarray(step), jk, jv,
                                         jnp.asarray(fills))
        got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(step), tk,
                                        tv, torch.from_numpy(fills))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_forward_cached_paged_int8_pool_matches_jax(cfg_name, policy):
    """The composed paged route over int8 pools (every helper on both
    leaves): publish two prefills into shuffled blocks, then decode."""
    jc, jp, tc, tp = _pair(cfg_name, policy, seed=1)
    bk, T, plens = 8, 4, (5, 13)
    b = len(plens)
    toks = _tokens(b, max(plens) + 3, jc.vocab_size, seed=3)
    n_blocks = 1 + b * T
    order = np.random.default_rng(4).permutation(b * T) + 1
    tables = np.zeros((b, T), np.int32)
    jkp, jvp = jm.init_kv_pool(jc, n_blocks, bk)
    tkp, tvp = tm.init_kv_pool(tc, n_blocks, bk, device="cpu")
    for s, plen in enumerate(plens):
        used = -(-(plen + 3) // bk)
        tables[s, :used] = order[s * T:s * T + used]
        scatter = np.where(np.arange(T) < -(-plen // bk), tables[s], 0)
        scatter = scatter.astype(np.int32)
        jk, jv = jm.init_kv_cache(jc, 1, T * bk)
        _, jk, jv = _jfc(jc, jp, jnp.asarray(toks[s:s + 1, :plen]),
                                      jk, jv, jnp.int32(0), empty_cache=True)
        jkp = _jscatter(jkp, jk, jnp.asarray(scatter))
        jvp = _jscatter(jvp, jv, jnp.asarray(scatter))
        tk, tv = tm.init_kv_cache(tc, 1, T * bk, device="cpu")
        _, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(
            toks[s:s + 1, :plen]), tk, tv, 0, empty_cache=True)
        tm.cache_scatter_blocks(tkp, tk, torch.from_numpy(scatter))
        tm.cache_scatter_blocks(tvp, tv, torch.from_numpy(scatter))
    fills = np.array(plens, np.int32)
    for i in range(3):
        step = np.stack([toks[s, plens[s] + i] for s in range(b)])[:, None]
        want, jkp, jvp = _jfcp(
            jc, jp, jnp.asarray(step), jkp, jvp, jnp.asarray(tables),
            jnp.asarray(fills))
        got, tkp, tvp = tm.forward_cached_paged(
            tc, tp, torch.from_numpy(step), tkp, tvp,
            torch.from_numpy(tables), torch.from_numpy(fills))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        fills = fills + 1
    np.testing.assert_allclose(tvp["scale"].numpy(), np.asarray(jvp["scale"]),
                               **TOL)


SLICE = dict(max_batch_size=2, max_seq_len=64, kv_block_size=8,
             prefill_bucket=8, prefix_cache_blocks=0, trace=False)
LENS = (3, 9, 5, 14, 7)
NEW = (6, 4, 9, 5, 7)


def _run(engine, prompts):
    engine.start()
    try:
        handles = [engine.submit(p, n, use_eos_stop=False)
                   for p, n in zip(prompts, NEW)]
        return [h.result(timeout=300) for h in handles], \
            engine.metrics.snapshot()
    finally:
        engine.shutdown()


@pytest.mark.parametrize("policy", ["int8", "mixed"])
def test_engine_greedy_tokens_match_jax(policy):
    """Five requests over two slots under an int8 KV cache and the policy:
    the same greedy tokens as the JAX engine (``fused_decode=False``, the
    route the JAX engine takes off a TPU), and every decode step counted
    under the policy's precision route."""
    jc, jp, tc, tp = _pair("gqa", policy)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 250, n).tolist() for n in LENS]
    want, jsnap = _run(JServingEngine(jc, jp, JEngineConfig(**SLICE)),
                       prompts)
    got, snap = _run(ServingEngine(tc, tp, EngineConfig(**SLICE),
                                   device="cpu"), prompts)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason == "length"
    assert snap["max_decode_batch"] == 2
    # counted at dispatch: a pipelined step whose slots all retired is
    # dispatched and dropped, so dispatches >= processed iterations
    routes = snap["step_routes"]
    assert list(routes) == [policy] and routes[policy]["fused"] == 0
    assert routes[policy]["fallback"] == snap["fallback_steps"] \
        >= snap["decode_iterations"]
    assert set(jsnap["fallback_steps_by_precision"]) == {policy}


def test_get_metrics_reports_step_routes():
    _, _, tc, tp = _pair("gqa", "mixed")
    server = MegatronServer(tc, tp, NullTokenizer(tc.vocab_size),
                            device="cpu", max_batch_size=2,
                            engine_max_seq_len=64, prefill_bucket=8,
                            kv_block_size=8, prefix_cache_blocks=0,
                            trace=False)
    server.run("127.0.0.1", 0, block=False)
    try:
        body = json.dumps({"prompts": ["3 4 5"],
                           "tokens_to_generate": 4}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/api",
                                     data=body, method="PUT")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics",
                timeout=120) as resp:
            snap = json.loads(resp.read())
    finally:
        server.shutdown()
    routes = snap["step_routes"]
    assert list(routes) == ["mixed"] and routes["mixed"]["fused"] == 0
    assert routes["mixed"]["fallback"] >= snap["decode_iterations"] >= 1
