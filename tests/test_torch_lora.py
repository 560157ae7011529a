"""The port's ``ops/lora.py`` against the JAX package's, mirroring
``tests/ops/test_lora.py``: a zero-init adapter changes nothing, the mask
keeps each row's own slot, the grouped epilogue equals the single-adapter
delta and the merged weights, install zeroes a target the adapter lacks,
and the checkpoint format is shared (a JAX-saved adapter loads in the port
with identical factors, and back).

Adapters are made on the JAX side (``init_lora_adapter`` and a non-zero B
from ``jax.random`` x 0.05, as the JAX tests make theirs) and cross as
numpy through ``convert.adapter_from_jax``.  fp32 throughout; tolerances
are stated per test (1e-6 where the same two products run in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.ops import lora as jl
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import adapter_from_jax, params_from_jax
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.ops import lora as tl

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
KW = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8)


@pytest.fixture(scope="module")
def cfgs():
    return jtiny(**KW), ttiny(**KW)


def _jax_adapter(cfg, seed, rank=4, zero_b=False, **kw):
    ad = jl.init_lora_adapter(cfg, jax.random.key(seed), rank, **kw)
    if zero_b:
        return ad
    return dataclasses.replace(ad, factors={
        t: {"a": f["a"],
            "b": jax.random.normal(jax.random.key(seed + 1000),
                                   f["b"].shape, f["b"].dtype) * 0.05}
        for t, f in ad.factors.items()})


def _np(ad):
    return {"rank": ad.rank, "alpha": ad.alpha, "targets": ad.targets,
            "factors": jax.tree.map(np.asarray, ad.factors)}


def _port(ad):
    return adapter_from_jax(_np(ad), device="cpu")


def _arenas(cfg, ads, rank):
    arenas = tl.make_arenas(cfg, len(ads), rank, ads[0].targets,
                            device="cpu")
    for s, ad in enumerate(ads):
        tl.install_adapter(arenas, ad.factors, s, ad.scale, rank)
    return arenas


def _forward_cached(cfg, params, toks, lora=None):
    k, v = tmodel.init_kv_cache(cfg, toks.shape[0], 16, device="cpu")
    logits, _, _ = tmodel.forward_cached(cfg, params, toks, k, v, 0,
                                         empty_cache=True, lora=lora)
    return logits


def test_zero_init_adapter_is_bitwise_noop(cfgs):
    """B = 0: the cached forward with the adapter installed equals the
    base forward bit for bit."""
    jc, tc = cfgs
    params = params_from_jax(jmodel.init_params(jax.random.key(0), jc),
                             device="cpu")
    ad = _port(_jax_adapter(jc, 1, zero_b=True))
    arenas = _arenas(tc, [ad, ad], 4)
    toks = torch.tensor([[3, 5, 7, 11]])
    mask = tl.slot_mask(torch.tensor([0]), 2, 4)
    assert torch.equal(_forward_cached(tc, params, toks),
                       _forward_cached(tc, params, toks, (arenas, mask)))


def test_slot_mask_selects_rank_columns():
    m = tl.slot_mask(torch.tensor([0, 2, -1]), n_slots=3, rank=2)
    expect = np.zeros((3, 6), np.float32)
    expect[0, 0:2] = 1.0
    expect[1, 4:6] = 1.0
    np.testing.assert_array_equal(m.numpy(), expect)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jl.slot_mask(
        jnp.asarray([0, 2, -1], jnp.int32), 3, 2)))


@pytest.mark.parametrize("slot", [0, 1, 2])
def test_grouped_epilogue_matches_single_delta(cfgs, slot):
    """The arena's delta at any slot equals that adapter's x·A·B·α/r
    alone (1e-5, as JAX's test), and JAX's grouped delta (1e-6)."""
    jc, tc = cfgs
    rank, n_slots = 4, 3
    jads = [_jax_adapter(jc, 10 + i, rank) for i in range(n_slots)]
    ads = [_port(a) for a in jads]
    arenas = _arenas(tc, ads, rank)
    jarenas = jl.make_arenas(jc, n_slots, rank, jads[0].targets)
    for s, a in enumerate(jads):
        jarenas = jl.install_adapter(jarenas, a.factors, s, a.scale, rank)
    assert tl.arena_sr(arenas) == n_slots * rank
    x = np.random.default_rng(7).normal(size=(2, tc.hidden_size)).astype(
        np.float32)
    mask = tl.slot_mask(torch.full((2,), slot), n_slots, rank)
    jmask = jl.slot_mask(jnp.full((2,), slot, jnp.int32), n_slots, rank)
    for t in ads[slot].targets:
        got = tl.lora_delta(torch.from_numpy(x), arenas[t]["a"][1],
                            arenas[t]["b"][1], mask)
        f = ads[slot].factors[t]
        want = (torch.from_numpy(x) @ f["a"][1]) @ (f["b"][1]
                                                    * ads[slot].scale)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        jwant = jl.lora_delta(jnp.asarray(x), jarenas[t]["a"][1],
                              jarenas[t]["b"][1], jmask)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)


def test_masked_out_rows_are_exact_zero(cfgs):
    jc, tc = cfgs
    ads = [_port(_jax_adapter(jc, 20 + i)) for i in range(2)]
    arenas = _arenas(tc, ads, 4)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, tc.hidden_size)).astype(np.float32))
    mask = tl.slot_mask(torch.tensor([-1, -1, -1]), 2, 4)
    d = tl.lora_delta(x, arenas["wq"]["a"][0], arenas["wq"]["b"][0], mask)
    assert torch.equal(d, torch.zeros_like(d))


def test_install_zeroes_untargeted_slot_columns(cfgs):
    jc, tc = cfgs
    full = _port(_jax_adapter(jc, 30))
    only_q = _port(_jax_adapter(jc, 31, targets=("wq",)))
    arenas = tl.make_arenas(tc, 2, 4, full.targets, device="cpu")
    tl.install_adapter(arenas, full.factors, 0, full.scale, 4)
    tl.install_adapter(arenas, only_q.factors, 0, only_q.scale, 4)
    assert not arenas["wv"]["a"][:, :, 0:4].any()
    assert not arenas["wv"]["b"][:, 0:4].any()
    assert arenas["wq"]["a"][:, :, 0:4].any()


def test_install_and_delta_match_jax(cfgs):
    """``install_adapter`` writes JAX's arena (α/r folded into B) and
    ``lora_delta`` over it gives JAX's delta, on the same numpy inputs,
    for a mask with rows at slots 1, -1 and 0 (1e-6)."""
    jc, tc = cfgs
    rank = 4
    jads = [_jax_adapter(jc, 70 + i, rank, alpha=8.0) for i in range(2)]
    jarenas = jl.make_arenas(jc, 2, rank, jads[0].targets)
    for s, a in enumerate(jads):
        jarenas = jl.install_adapter(jarenas, a.factors, s, a.scale, rank)
    arenas = _arenas(tc, [_port(a) for a in jads], rank)
    for t in arenas:
        for k in ("a", "b"):
            np.testing.assert_allclose(arenas[t][k].numpy(),
                                       np.asarray(jarenas[t][k]), **TOL)
    x = np.random.default_rng(4).normal(size=(3, 5, tc.hidden_size)).astype(
        np.float32)
    slots = np.asarray([1, -1, 0], np.int32)
    mask = tl.slot_mask(torch.from_numpy(slots), 2, rank)
    jmask = jl.slot_mask(jnp.asarray(slots), 2, rank)
    for t in ("wq", "wv"):
        got = tl.lora_delta(torch.from_numpy(x), arenas[t]["a"][0],
                            arenas[t]["b"][0], mask)
        want = jl.lora_delta(jnp.asarray(x), jarenas[t]["a"][0],
                             jarenas[t]["b"][0], jmask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_epilogue_agrees_with_merged_weights(cfgs):
    """The cached forward with the adapter in the arena equals the cached
    forward of ``merge_adapter``'s weights (1e-5: x·W + (x·A)·B against
    x·(W + A·B) in fp32), every target adapted."""
    jc, tc = cfgs
    params = params_from_jax(jmodel.init_params(jax.random.key(0), jc),
                             device="cpu")
    ad = _port(_jax_adapter(jc, 40, targets=tuple(
        jl.lora_target_shapes(jc))))
    arenas = _arenas(tc, [ad], ad.rank)
    toks = torch.tensor([[3, 5, 7, 11, 2]])
    mask = tl.slot_mask(torch.tensor([0]), 1, ad.rank)
    via_arena = _forward_cached(tc, params, toks, (arenas, mask))
    via_merge = _forward_cached(tc, tl.merge_adapter(params, ad), toks)
    torch.testing.assert_close(via_arena, via_merge, rtol=1e-5, atol=1e-5)


def test_merge_rejects_quantized_base(cfgs):
    from megatron_llm_tpu_torch.ops.quant import quantize_params

    jc, tc = cfgs
    params = quantize_params(tmodel.init_params(tc, device="cpu"), "int8")
    with pytest.raises(ValueError, match="quantized"):
        tl.merge_adapter(params, _port(_jax_adapter(jc, 50)))


def test_adapter_checkpoint_round_trip(cfgs, tmp_path):
    jc, tc = cfgs
    ad = _port(_jax_adapter(jc, 60, rank=8))
    tl.save_adapter(str(tmp_path / "adapter"), ad)
    back = tl.load_adapter(str(tmp_path / "adapter"))
    assert (back.rank, back.alpha, back.targets) == (ad.rank, ad.alpha,
                                                     ad.targets)
    for t in ad.targets:
        for k in ("a", "b"):
            assert torch.equal(back.factors[t][k], ad.factors[t][k])
    tl.validate_adapter(tc, back)


def test_checkpoints_cross_between_the_packages(cfgs, tmp_path):
    """An adapter saved by the JAX package loads in the port with
    identical factors, and one saved by the port loads in JAX."""
    jc, tc = cfgs
    jad = _jax_adapter(jc, 61, rank=8, alpha=16.0)
    jl.save_adapter(str(tmp_path / "jax"), jad)
    back = tl.load_adapter(str(tmp_path / "jax"))
    assert (back.rank, back.alpha, back.targets) == (jad.rank, jad.alpha,
                                                     jad.targets)
    for t in jad.targets:
        for k in ("a", "b"):
            np.testing.assert_array_equal(back.factors[t][k].numpy(),
                                          np.asarray(jad.factors[t][k]))
    tl.save_adapter(str(tmp_path / "port"), back)
    again = jl.load_adapter(str(tmp_path / "port"))
    for t in jad.targets:
        np.testing.assert_array_equal(np.asarray(again.factors[t]["b"]),
                                      np.asarray(jad.factors[t]["b"]))


def test_adapter_from_jax_keeps_the_factors(cfgs):
    jc, _ = cfgs
    jad = _jax_adapter(jc, 62)
    ad = adapter_from_jax(_np(jad), device="cpu")
    assert (ad.rank, ad.alpha, ad.targets, ad.scale) == (
        jad.rank, jad.alpha, jad.targets, jad.scale)
    assert ad.nbytes == jad.nbytes
    for t in jad.targets:
        np.testing.assert_array_equal(ad.factors[t]["a"].numpy(),
                                      np.asarray(jad.factors[t]["a"]))


def test_validate_rejects_wrong_shapes(cfgs):
    jc, tc = cfgs
    ad = _port(_jax_adapter(jc, 0))
    bad = dataclasses.replace(ad, factors={
        t: {"a": f["a"][:, :-1, :], "b": f["b"]}
        for t, f in ad.factors.items()})
    with pytest.raises(ValueError, match="shape"):
        tl.validate_adapter(tc, bad)
    with pytest.raises(ValueError, match="unknown"):
        tl.init_lora_adapter(tc, torch.Generator().manual_seed(0), 4,
                             targets=("nope",))


def test_target_shapes_cover_glu(cfgs):
    jc, tc = cfgs
    assert tl.lora_target_shapes(tc) == jl.lora_target_shapes(jc)
    shapes = tl.lora_target_shapes(tc)
    assert shapes["wq"] == (tc.hidden_size,
                            tc.num_attention_heads * tc.head_dim)
    assert shapes["wv"][1] == tc.kv_heads * tc.head_dim
    assert ("w_gate" in shapes) == tc.is_glu
    assert tl.LORA_TARGETS == jl.LORA_TARGETS
    assert tl.DEFAULT_TARGETS == jl.DEFAULT_TARGETS


def test_init_adapter_draws_from_the_generator(cfgs):
    """A fresh adapter: B exactly zero, A ~ N(0, 1/in) from the given
    generator (the same seed gives the same factors)."""
    _, tc = cfgs
    a1 = tl.init_lora_adapter(tc, torch.Generator().manual_seed(5), 8,
                              targets=("wq", "w_down"))
    a2 = tl.init_lora_adapter(tc, torch.Generator().manual_seed(5), 8,
                              targets=("wq", "w_down"))
    assert not a1.factors["wq"]["b"].any()
    assert torch.equal(a1.factors["w_down"]["a"], a2.factors["w_down"]["a"])
    std = float(a1.factors["w_down"]["a"].std()) * tc.ffn_size ** 0.5
    assert 0.8 < std < 1.2
