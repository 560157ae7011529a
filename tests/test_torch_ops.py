"""The port's ops and config against the JAX package's, fp32 on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import config as jconfig
from megatron_llm_tpu.ops import activations as jact
from megatron_llm_tpu.ops import attention as jattn
from megatron_llm_tpu.ops import kv_quant as jkv
from megatron_llm_tpu.ops import norms as jnorms
from megatron_llm_tpu.ops import rope as jrope
from megatron_llm_tpu_torch import config as tconfig
from megatron_llm_tpu_torch.ops import activations as tact
from megatron_llm_tpu_torch.ops import attention as tattn
from megatron_llm_tpu_torch.ops import kv_quant as tkv
from megatron_llm_tpu_torch.ops import norms as tnorms
from megatron_llm_tpu_torch.ops import rope as trope

torch.set_num_threads(1)

# fp32 on both sides with the same formulas; only the order of sums (and
# XLA's transcendental approximations) differs
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(tconfig.PRESETS))
def test_presets_match_jax(name):
    t, j = tconfig.get_preset(name), jconfig.get_preset(name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.kv_heads, t.head_dim, t.ffn_size, t.padded_vocab_size()) == \
        (j.kv_heads, j.head_dim, j.ffn_size, j.padded_vocab_size())
    assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name


def test_config_defaults_match_jax():
    t, j = tconfig.ModelConfig(), jconfig.ModelConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_apply(norm_type):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 7, 64)
    params = {"scale": 1.0 + 0.1 * _rand(rng, 64)}
    if norm_type == "layernorm":
        params["bias"] = 0.1 * _rand(rng, 64)
    want = jnorms.norm_apply(norm_type, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in params.items()},
                             1e-5)
    got = tnorms.norm_apply(norm_type, torch.from_numpy(x),
                            {k: torch.from_numpy(v)
                             for k, v in params.items()}, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the kernel route (RMSNorm's or LayerNorm's autograd Function) takes
    # its plain version on CPU tensors
    got_k = tnorms.norm_apply(norm_type, torch.from_numpy(x),
                              {k: torch.from_numpy(v)
                               for k, v in params.items()}, 1e-5,
                              impl="pallas")
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(tact.ACTIVATIONS))
def test_activations(name):
    rng = np.random.default_rng(1)
    x = 2.0 * _rand(rng, 3, 16)
    want = jact.get_activation(name)(jnp.asarray(x))
    got = tact.get_activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert tact.is_glu(name) == jact.is_glu(name)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scaling_type="linear", scaling_factor=4.0),
    dict(scaling_type="llama3", scaling_factor=8.0, low_freq_factor=1.0,
         high_freq_factor=4.0, original_max_positions=64),
    dict(scaling_type="yarn", scaling_factor=4.0, original_max_positions=64,
         theta=500000.0),
])
def test_rope_tables_and_apply(kw):
    cos_j, sin_j = jrope.precompute_rope_freqs(32, 256, **kw)
    cos_t, sin_t = trope.precompute_rope_freqs(32, 256, **kw)
    # the angles t * inv_freq reach ~250 rad: fp32 argument rounding
    # differs by a few ulps of 250 between XLA's and torch's cos/sin
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=5e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=5e-5)
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 9, 3, 32)
    pos = rng.integers(0, 256, (2, 9)).astype(np.int64)
    cj, sj = jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy())
    for p_np in (None, pos):
        want = jrope.apply_rope(jnp.asarray(x), cj, sj,
                                None if p_np is None else jnp.asarray(p_np))
        got = trope.apply_rope(torch.from_numpy(x), cos_t, sin_t,
                               None if p_np is None
                               else torch.from_numpy(p_np))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_rope_is_interleaved_pairs():
    """Pairs (x[2i], x[2i+1]) rotate together, not HF's rotate-half."""
    cos, sin = trope.precompute_rope_freqs(4, 8)
    x = torch.tensor([1.0, 0.0, 0.0, 0.0]).reshape(1, 1, 1, 4)
    pos = torch.tensor([[3]])
    out = trope.apply_rope(x, cos, sin, pos).reshape(4)
    torch.testing.assert_close(out[:2], torch.stack([cos[3, 0], sin[3, 0]]))
    assert float(out[2:].abs().max()) == 0.0


@pytest.mark.parametrize("causal,segs,bias,sq,sk,hq,hk", [
    (True, False, False, 9, 9, 4, 2),
    (True, False, False, 5, 13, 4, 4),     # causal with sq < sk
    (True, True, False, 12, 12, 4, 1),     # segment ids, MQA
    (False, False, True, 6, 6, 2, 2),      # additive bias
])
def test_dot_product_attention(causal, segs, bias, sq, sk, hq, hk):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, sq, hq, 16), _rand(rng, 2, sk, hk, 16), \
        _rand(rng, 2, sk, hk, 16)
    seg = (np.arange(sq)[None, :] // 5).repeat(2, 0).astype(np.int32) \
        if segs else None
    b_np = _rand(rng, 2, 1, sq, sk) if bias else None
    want = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg),
        bias=None if b_np is None else jnp.asarray(b_np))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        bias=None if b_np is None else torch.from_numpy(b_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the dispatcher's two routes agree where the flash route applies
    if not bias:
        got_f = tattn.attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            impl="flash", causal=causal,
            segment_ids=None if seg is None else torch.from_numpy(seg))
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,cache_len", [(1, 7), (1, [3, 20]), (3, 5),
                                         (2, [0, 11])])
def test_decode_attention(s, cache_len):
    rng = np.random.default_rng(4)
    b, hq, hk, max_len, d = 2, 4, 2, 32, 16
    q = _rand(rng, b, s, hq, d)
    k, v = _rand(rng, b, hk, max_len, d), _rand(rng, b, hk, max_len, d)
    cl = np.asarray(cache_len, np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cl))
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # CPU tensors never take the kernel route
    assert not tattn.decode_kernel_eligible(torch.from_numpy(q),
                                            torch.from_numpy(k))


@pytest.mark.parametrize("pos", [4, [2, 9]])
def test_cache_update_in_place(pos):
    rng = np.random.default_rng(5)
    cache = _rand(rng, 2, 2, 16, 8)
    rows = _rand(rng, 2, 2, 3, 8)
    p = np.asarray(pos, np.int32)
    want = jkv.cache_update(jnp.asarray(cache), jnp.asarray(rows),
                            jnp.asarray(p))
    t = torch.from_numpy(cache.copy())
    got = tkv.cache_update(t, torch.from_numpy(rows),
                           pos if isinstance(pos, int) else torch.from_numpy(p))
    assert got is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


def test_int8_cache_is_refused():
    """The int8 cache form is written now (``tests/test_torch_quant.py``
    holds it against JAX); what is refused is a pair whose leaves are not
    int8 codes and fp32 scales."""
    cache = {"q": torch.zeros(1, 1, 4, 8, dtype=torch.int8),
             "scale": torch.zeros(1, 1, 4)}
    assert tkv.is_quantized_cache(cache)
    tkv.cache_update(cache, torch.ones(1, 1, 1, 8), 2)
    assert cache["q"][0, 0, 2].tolist() == [127] * 8
    assert cache["scale"][0, 0].tolist() == [0.0, 0.0, tkv._RCP127, 0.0]
    bad = {"q": torch.zeros(1, 1, 4, 8), "scale": torch.zeros(1, 1, 4)}
    with pytest.raises(TypeError, match="int8"):
        tkv.cache_update(bad, torch.zeros(1, 1, 1, 8), 0)
