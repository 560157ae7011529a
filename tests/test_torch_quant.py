"""The port's int8 KV cache and weight quantization against the JAX
package's, on the CPU: codes, scales and int4 packing bit for bit, the
quantized matmul within fp32 reordering, and the same quantized leaf set
under each precision preset."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops import kv_quant as jkv
from megatron_llm_tpu.ops import quant as jq
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.ops import kv_quant as tkv
from megatron_llm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rows(seed=0):
    """Rows of mixed magnitude, with an all-zero row and exact ties."""
    rng = np.random.default_rng(seed)
    rows = _rand(rng, 2, 3, 5, 64, scale=3.0)
    rows[0, 0, 0] = 0.0
    rows[1, 2, 1, :4] = [127.0, 0.5, -0.5, 1.5]   # halves: round to even
    return rows


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_quantize_rows_bitwise():
    rows = _rows()
    want = jkv.quantize_rows(jnp.asarray(rows))
    got = tkv.quantize_rows(torch.from_numpy(rows))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    _eq(got["q"], want["q"])
    _eq(got["scale"], want["scale"])


def test_fake_quantize_rows_bitwise_and_idempotent():
    rows = _rows(1)
    fq = tkv.fake_quantize_rows(torch.from_numpy(rows))
    _eq(fq, jkv.fake_quantize_rows(jnp.asarray(rows)))
    # what the cache holds after a write; requantizing it gives the same
    # codes back, and the scale within one ulp: amax(fq) * (1/127) is
    # two roundings away from the first scale, and JAX's own requantize
    # drifts the same rows (ROADMAP.md, Queue 3: found in the reference)
    direct = tkv.quantize_rows(torch.from_numpy(rows))
    _eq(fq, tkv.dequantize_cache(direct))
    again = tkv.quantize_rows(fq)
    assert torch.equal(again["q"], direct["q"])
    ulps = again["scale"].view(torch.int32) - direct["scale"].view(torch.int32)
    assert int(ulps.abs().max()) <= 1
    j_again = jkv.quantize_rows(jkv.fake_quantize_rows(jnp.asarray(rows)))
    _eq(again["scale"], j_again["scale"])


@pytest.mark.parametrize("pos", [4, 13, [2, 9], [0, 14]])
def test_int8_cache_update_bitwise(pos):
    """Scalar and [b] positions (14 clamps to max_len - s), both leaves
    written in place."""
    rng = np.random.default_rng(2)
    rows = _rand(rng, 2, 2, 3, 16)
    jcache = jkv.init_quantized_cache((2, 2, 16, 16))
    p = np.asarray(pos, np.int32)
    want = jkv.cache_update(jcache, jnp.asarray(rows), jnp.asarray(p))
    cache = tkv.init_quantized_cache((2, 2, 16, 16), device="cpu")
    ids = {k: v.data_ptr() for k, v in cache.items()}
    got = tkv.cache_update(cache, torch.from_numpy(rows),
                           pos if isinstance(pos, int)
                           else torch.from_numpy(p))
    assert got is cache and {k: v.data_ptr() for k, v in got.items()} == ids
    _eq(got["q"], want["q"])
    _eq(got["scale"], want["scale"])


def test_quantize_weight_bitwise():
    rng = np.random.default_rng(3)
    for w in (_rand(rng, 64, 48, scale=0.02), _rand(rng, 2, 64, 48)):
        w[..., 5] = 0.0                             # an all-zero column
        want = jq.quantize_weight(jnp.asarray(w))
        got = tq.quantize_weight(torch.from_numpy(w))
        _eq(got["q"], want["q"])
        _eq(got["scale"], want["scale"])
        _eq(tq.dequantize_weight(got), jq.dequantize_weight(want))


@pytest.mark.parametrize("group", [32, 128])
def test_quantize_weight_int4_bitwise(group):
    rng = np.random.default_rng(4)
    w = _rand(rng, 2, 256, 40, scale=0.05)
    want = jq.quantize_weight_int4(jnp.asarray(w), group)
    got = tq.quantize_weight_int4(torch.from_numpy(w), group)
    assert got["q"].shape == (2, 128, 40)
    assert got["scale"].shape == (2, 256 // group, 40)
    _eq(got["q"], want["q"])
    _eq(got["scale"], want["scale"])
    assert tq.is_quantized_int4(got) and tq.weight_bits(got) == 4
    assert tq.int4_group_size(got) == group
    _eq(tq.dequantize_weight(got), jq.dequantize_weight(want))
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.zeros(100, 8), 32)


def test_pack_unpack_int4_bitwise():
    """Every nibble value in both positions: even rows in the low nibble,
    sign extension through the int32 shifts."""
    vals = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals, indexing="ij"), axis=0)  # [2,16,16]
    q = q.transpose(1, 0, 2).reshape(32, 16)  # row pairs: (a, b) pairs
    packed = tq.pack_int4(torch.from_numpy(q))
    _eq(packed, jq.pack_int4(jnp.asarray(q)))
    assert packed.dtype == torch.int8
    _eq(tq.unpack_int4(packed), jq.unpack_int4(jnp.asarray(np.asarray(
        packed))))
    assert torch.equal(tq.unpack_int4(packed), torch.from_numpy(q))


def test_quantize_embedding_and_lookup_bitwise():
    rng = np.random.default_rng(5)
    word = _rand(rng, 50, 32, scale=0.02)
    tokens = rng.integers(0, 50, (3, 7))
    want = jq.quantize_embedding(jnp.asarray(word))
    got = tq.quantize_embedding(torch.from_numpy(word))
    _eq(got["q"], want["q"])
    _eq(got["scale"], want["scale"])
    _eq(tq.embedding_lookup(got, torch.from_numpy(tokens)),
        jq.embedding_lookup(want, jnp.asarray(tokens)))
    plain = tq.embedding_lookup(torch.from_numpy(word),
                                torch.from_numpy(tokens))
    _eq(plain, word[tokens])


@pytest.mark.parametrize("form", ["int8", "int4", "plain"])
def test_mm_matches_jax(form):
    rng = np.random.default_rng(6)
    x = _rand(rng, 3, 5, 128)
    w = _rand(rng, 128, 24, scale=0.05)
    jw = {"int8": jq.quantize_weight, "int4": jq.quantize_weight_int4,
          "plain": lambda a: a}[form](jnp.asarray(w))
    tw = params_from_jax(jax.tree.map(np.asarray, {"w": jw}),
                         device="cpu")["w"]
    want = np.asarray(jq.mm(jnp.asarray(x), jw))
    got = tq.mm(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _leaf_forms(tree, prefix=""):
    """{path: bits} of every leaf, quantized leaves as one entry."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict) and set(v) != {"q", "scale"}:
            out.update(_leaf_forms(v, path + "."))
        elif isinstance(v, dict):
            out[path] = (4 if v["scale"].ndim == v["q"].ndim else 8,
                         tuple(v["q"].shape), tuple(v["scale"].shape))
        else:
            out[path] = (0, tuple(v.shape))
    return out


@pytest.mark.parametrize("preset", ["int8", "int4", "mixed"])
def test_quantize_params_matches_jax(preset):
    """The same quantized leaf set as JAX under each preset, leaf for leaf
    bitwise; with group 128 the tiny config's 64-row inputs fall back to
    int8 (hidden 64), the 128-row w_down takes int4.  Tied tables stay
    plain."""
    jc = jtiny(fused_decode=False)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want = jq.quantize_params(jp, preset)
    got = tq.quantize_params(tp, preset)
    forms = _leaf_forms(got)
    assert forms == _leaf_forms(jax.tree.map(np.asarray, want))
    if preset != "int8":
        assert forms["layers.mlp.w_down"][0] == 4
        assert forms["layers.mlp.w_up"][0] == 8       # 64 % 128: fallback
        assert forms["embedding.word"][0] == 8
    want_np = jax.tree.map(np.asarray, want)

    def walk(t, w):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, w[k])
            else:
                np.testing.assert_array_equal(v.numpy(), w[k])

    walk(got, want_np)
    assert tq.precision_route(got) == jq.precision_route(want)
    # a tied table is never quantized (it is also the unembed matrix)
    tied = tq.quantize_params({"embedding": {"word": tp["embedding"]["word"]},
                               "layers": tp["layers"]}, preset)
    assert isinstance(tied["embedding"]["word"], torch.Tensor)
    # leaves left alone are the caller's own tensors, not copies
    assert got["final_norm"]["scale"] is tp["final_norm"]["scale"]


def test_precision_route_labels():
    jc = jtiny(fused_decode=False)
    jp = jm.init_params(jax.random.key(1), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert tq.precision_route(tp) == jq.precision_route(jp) == "fp32"
    # the int4 preset's group 128 leaves the 64-row inputs at int8: mixed
    for name, pol in [("int8", "int8"), ("mixed", "int4"), ("mixed", "mixed"),
                      ("int4", tq.PrecisionPolicy("int4", "int4", "none", 32))]:
        jpol = pol if isinstance(pol, str) else jq.PrecisionPolicy(
            **dataclasses.asdict(pol))
        got = tq.precision_route(tq.quantize_params(tp, pol))
        assert got == jq.precision_route(jq.quantize_params(jp, jpol)) == name
    attn_only = tq.quantize_params(tp, tq.PrecisionPolicy(mlp="none"))
    assert tq.precision_route(attn_only) == "mixed"   # int8 beside plain
    assert tq.resolve_policy(None) == tq.POLICIES["int8"]
    assert dataclasses.asdict(tq.POLICIES["mixed"]) == dataclasses.asdict(
        jq.POLICIES["mixed"])


def test_convert_carries_quantized_leaves_bitwise():
    """Quantized JAX leaves (int8 codes, packed int4, fp32 scales) cross
    ``params_from_jax`` bit for bit, in their dtypes."""
    jc = jtiny(fused_decode=False)
    jp = jq.quantize_params(jm.init_params(jax.random.key(2), jc),
                            jq.PrecisionPolicy("int8", "int4", "int8", 32))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, device="cpu")
    wd = tp["layers"]["mlp"]["w_down"]
    assert wd["q"].dtype == torch.int8 and wd["scale"].dtype == torch.float32
    assert tq.weight_bits(wd) == 4
    assert tq.weight_bits(tp["layers"]["attn"]["wq"]) == 8
    assert tq.is_quantized(tp["embedding"]["word"])

    def walk(t, w):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, w[k])
            else:
                assert v.numpy().dtype == w[k].dtype
                np.testing.assert_array_equal(v.numpy(), w[k])

    walk(tp, np_tree)
