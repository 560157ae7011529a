"""The port's model against the JAX package's, fp32 on the CPU.

Weights are the JAX package's (``init_params`` from a JAX key) carried
across with ``params_from_jax``; tokens are made with numpy from a seed.
With ``attention_impl="flash"`` / ``norm_impl="pallas"`` the JAX side runs
its Pallas kernels in interpret mode and the port its kernels' plain
versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm

torch.set_num_threads(1)

# fp32 end to end on both sides: two layers of matmuls, softmax and norms
# whose sums run in a different order; logits are O(0.1-1)
TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = [("dot", "xla"), ("dot", "pallas"), ("flash", "xla"),
         ("flash", "pallas")]


# JAX's model functions as one program a config and shape (called eagerly,
# each op compiles on its own)
_jforward = jax.jit(jm.forward, static_argnums=0)
_jforward_cached = jax.jit(jm.forward_cached, static_argnums=0,
                           static_argnames="empty_cache")
_jforward_cached_paged = jax.jit(jm.forward_cached_paged, static_argnums=0)


def _pair(attn="dot", norm="xla", **kw):
    jc = jtiny(attention_impl=attn, norm_impl=norm, fused_decode=False, **kw)
    tc = ttiny(attention_impl=attn, norm_impl=norm, fused_decode=False, **kw)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("attn,norm", IMPLS)
def test_forward_logits(attn, norm):
    jc, jp, tc, tp = _pair(attn, norm)
    toks = _tokens(2, 11, jc.vocab_size)
    want = _jforward(jc, jp, jnp.asarray(toks))
    got = tm.forward(tc, tp, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn,norm", IMPLS)
def test_prefill_then_decode(attn, norm):
    """forward_cached(empty_cache=True) over a prompt, then single-token
    steps at per-row fills, against JAX step for step."""
    jc, jp, tc, tp = _pair(attn, norm)
    b, plen, max_len, steps = 2, 9, 32, 4
    toks = _tokens(b, plen + steps, jc.vocab_size, seed=1)
    jk, jv = jm.init_kv_cache(jc, b, max_len)
    tk, tv = tm.init_kv_cache(tc, b, max_len, device="cpu")
    want, jk, jv = _jforward_cached(jc, jp, jnp.asarray(toks[:, :plen]), jk,
                                     jv, jnp.int32(0), empty_cache=True)
    got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(toks[:, :plen]),
                                    tk, tv, 0, empty_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    for i in range(steps):
        fills = np.full((b,), plen + i, np.int32)
        step = toks[:, plen + i:plen + i + 1]
        want, jk, jv = _jforward_cached(jc, jp, jnp.asarray(step), jk, jv,
                                         jnp.asarray(fills))
        got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(step), tk,
                                        tv, torch.from_numpy(fills))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_logit_rows_and_last_logit_only():
    jc, jp, tc, tp = _pair()
    toks = _tokens(2, 8, jc.vocab_size, seed=2)
    rows = np.array([3, 7], np.int32)
    jk, jv = jm.init_kv_cache(jc, 2, 16)
    tk, tv = tm.init_kv_cache(tc, 2, 16, device="cpu")
    want, _, _ = _jforward_cached(jc, jp, jnp.asarray(toks), jk, jv,
                                   jnp.int32(0), empty_cache=True,
                                   logit_rows=jnp.asarray(rows))
    got, _, _ = tm.forward_cached(tc, tp, torch.from_numpy(toks), tk, tv, 0,
                                  empty_cache=True,
                                  logit_rows=torch.from_numpy(rows))
    assert got.shape == (2, 1, want.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tk.zero_()
    tv.zero_()
    last, _, _ = tm.forward_cached(tc, tp, torch.from_numpy(toks), tk, tv, 0,
                                   empty_cache=True, last_logit_only=True)
    np.testing.assert_allclose(last[1].numpy(), got[1].numpy(), **TOL)


@pytest.mark.parametrize("attn,norm", [("dot", "xla"), ("flash", "pallas")])
def test_paged_decode_matches_dense_and_jax(attn, norm):
    """The composed paged route (gather → forward_cached → append rows)
    against JAX's, and against the dense cache it mirrors."""
    jc, jp, tc, tp = _pair(attn, norm)
    bk, T, plens = 8, 4, (5, 13)
    b = len(plens)
    width = T * bk
    toks = _tokens(b, max(plens) + 3, jc.vocab_size, seed=3)
    n_blocks = 1 + b * T
    # slot s owns blocks 1 + s*T ... ; tables point unused entries at trash
    tables = np.zeros((b, T), np.int32)
    jkp, jvp = jm.init_kv_pool(jc, n_blocks, bk)
    tkp, tvp = tm.init_kv_pool(tc, n_blocks, bk, device="cpu")
    tdk, tdv = tm.init_kv_cache(tc, b, width, device="cpu")
    for s, plen in enumerate(plens):
        used = -(-(plen + 3) // bk)
        bids = np.arange(1 + s * T, 1 + s * T + used, dtype=np.int32)
        tables[s, :used] = bids
        scatter = np.zeros((T,), np.int32)
        scatter[:used] = bids
        jk, jv = jm.init_kv_cache(jc, 1, width)
        _, jk, jv = _jforward_cached(jc, jp, jnp.asarray(toks[s:s + 1, :plen]),
                                      jk, jv, jnp.int32(0), empty_cache=True)
        jkp = jm.cache_scatter_blocks(jkp, jk, jnp.asarray(scatter))
        jvp = jm.cache_scatter_blocks(jvp, jv, jnp.asarray(scatter))
        tk, tv = tm.init_kv_cache(tc, 1, width, device="cpu")
        _, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(
            toks[s:s + 1, :plen]), tk, tv, 0, empty_cache=True)
        tm.cache_scatter_blocks(tkp, tk, torch.from_numpy(scatter))
        tm.cache_scatter_blocks(tvp, tv, torch.from_numpy(scatter))
        tdk[:, s] = tk[:, 0]
        tdv[:, s] = tv[:, 0]
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)
    gathered = tm.cache_gather_blocks(tkp, torch.from_numpy(tables))
    np.testing.assert_allclose(
        gathered.numpy(),
        np.asarray(jm.cache_gather_blocks(jkp, jnp.asarray(tables))), **TOL)
    fills = np.array(plens, np.int32)
    for i in range(3):
        step = np.stack([toks[s, plens[s] + i] for s in range(b)])[:, None]
        want, jkp, jvp = _jforward_cached_paged(
            jc, jp, jnp.asarray(step), jkp, jvp, jnp.asarray(tables),
            jnp.asarray(fills))
        got, tkp, tvp = tm.forward_cached_paged(
            tc, tp, torch.from_numpy(step), tkp, tvp,
            torch.from_numpy(tables), torch.from_numpy(fills))
        dense, tdk, tdv = tm.forward_cached(tc, tp, torch.from_numpy(step),
                                            tdk, tdv, torch.from_numpy(fills))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # paged and dense are the same arithmetic on the same rows
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                                   atol=1e-6)
        fills = fills + 1
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), **TOL)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), **TOL)


def test_cache_row_helpers():
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(2, 6, 2, 4, 8)).astype(np.float32)
    rows = rng.normal(size=(2, 3, 2, 1, 8)).astype(np.float32)
    bids, offs = np.array([1, 4, 2], np.int32), np.array([0, 3, 2], np.int32)
    want = jm.cache_append_rows(jnp.asarray(pool), jnp.asarray(rows),
                                jnp.asarray(bids), jnp.asarray(offs))
    t = torch.from_numpy(pool.copy())
    tm.cache_append_rows(t, torch.from_numpy(rows), torch.from_numpy(bids),
                         torch.from_numpy(offs))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    dense = rng.normal(size=(2, 3, 2, 16, 8)).astype(np.float32)
    fills = np.array([0, 7, 15], np.int32)
    np.testing.assert_array_equal(
        tm.cache_rows_at(torch.from_numpy(dense),
                         torch.from_numpy(fills)).numpy(),
        np.asarray(jm.cache_rows_at(jnp.asarray(dense), jnp.asarray(fills))))


def test_init_params_layout_and_distribution():
    """The port's own init draws the JAX package's tree: same keys and
    shapes, std 0.02, output layers scaled by 1/sqrt(2 L), norms 1."""
    jc = jtiny(fused_decode=False, hidden_size=128, ffn_hidden_size=512)
    tc = ttiny(fused_decode=False, hidden_size=128, ffn_hidden_size=512)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), jc))
    tp = tm.init_params(tc, seed=0, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(tp) == shapes(jp)
    std = tc.init_method_std
    out_std = std / np.sqrt(2.0 * tc.num_layers)
    # ~8-65k draws each: the sample std is within 3% of the target
    for w, s in ((tp["layers"]["attn"]["wq"], std),
                 (tp["layers"]["mlp"]["w_up"], std),
                 (tp["embedding"]["word"], std),
                 (tp["layers"]["attn"]["wo"], out_std),
                 (tp["layers"]["mlp"]["w_down"], out_std)):
        assert abs(float(w.std()) / s - 1.0) < 0.03
    assert bool((tp["final_norm"]["scale"] == 1).all())
    again = tm.init_params(tc, seed=0, device="cpu")
    assert torch.equal(again["lm_head"], tp["lm_head"])
    assert not torch.equal(tm.init_params(tc, seed=1, device="cpu")["lm_head"],
                           tp["lm_head"])


def test_bf16_params_convert_bitwise():
    jc = jtiny(params_dtype="bfloat16", fused_decode=False)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(1), jc))
    tp = params_from_jax(jp, device="cpu")
    w = tp["layers"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        jp["layers"]["attn"]["wq"].view(np.int16))
    assert dataclasses.asdict(ttiny(params_dtype="bfloat16"))["params_dtype"] \
        == "bfloat16"
