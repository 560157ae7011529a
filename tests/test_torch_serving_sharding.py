"""The serving re-layout's specs and guards against the JAX package (mirror
of the serving half of ``megatron_llm_tpu/models/sharding.py``,
``ops/quant.quantize_specs`` and ``tests/serving/test_pp_serving.py::
test_pp_geometry_guard_names_the_axis``), in one process: no world.

The spec trees equal JAX's leaf for leaf (a spec is the tuple of a
``PartitionSpec``) for Llama, MQA and GPT with biases, over fp32 and int8
caches and plain, int8, int4 and mixed weights, at (tp, pp, fsdp) in
(2,1,1), (1,2,1), (1,1,2) and (2,2,1).  The sharded engines themselves run
in ``tests/test_torch_sharded_serving.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.models import sharding as jshard
from megatron_llm_tpu.ops import quant as jquant
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu_torch import config as tconfig
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.kernels.decode_step import (
    fused_paged_decode_eligible,
    mesh_shards_stack,
)
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.models import sharding as tshard
from megatron_llm_tpu_torch.ops import quant as tquant
from megatron_llm_tpu_torch.parallel import mesh as tmesh
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving.cluster import (
    build_cluster,
    build_disagg_cluster,
    build_sharded_engine,
)

import torch_world

torch.set_num_threads(1)


def shape_mesh(parallel) -> tmesh.Mesh:
    """A mesh of ``parallel``'s shape with no groups (rank 0's view):
    enough to state a layout."""
    shape = (parallel.data_parallel, parallel.fsdp,
             parallel.pipeline_parallel, parallel.context_parallel,
             parallel.expert_parallel, parallel.tensor_parallel, 1)
    return tmesh.Mesh(shape=dict(zip(tmesh.AXIS_ORDER, shape)),
                      coords={a: 0 for a in tmesh.AXIS_ORDER}, groups={},
                      world_size=int(np.prod(shape)))

# hidden 128 and ffn 256: int4's group of 128 divides every input dim
LLAMA = dict(num_layers=2, hidden_size=128, num_attention_heads=8,
             num_kv_heads=8, ffn_hidden_size=256, vocab_size=256,
             params_dtype="float32")
FAMILIES = {
    "llama": LLAMA,
    "mqa": dict(LLAMA, num_kv_heads=1, tie_embed_logits=False),
    "gpt_bias": dict(LLAMA, norm_type="layernorm", activation="gelu",
                     position_embedding_type="absolute", use_bias=True,
                     tie_embed_logits=True, num_kv_heads=None,
                     vocab_size=250),
}
DEGREES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1)]
POLICIES = [None, "int8", "int4", "mixed"]


def _par(cls, deg):
    tp, pp, fsdp = deg
    return cls(tensor_parallel=tp, pipeline_parallel=pp, fsdp=fsdp)


def _flat(specs):
    """A spec tree as ``{path: tuple}``, JAX's (``PartitionSpec`` leaves)
    or the port's (tuple leaves)."""
    return torch_world.flatten(jax.tree.map(
        tuple, specs, is_leaf=lambda x: isinstance(x, (PartitionSpec,
                                                        tuple))))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, kw in FAMILIES.items():
        jp = jm.init_params(jax.random.key(1), jtiny(**kw))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        for pol in POLICIES:
            out[name, pol] = (jp if pol is None
                              else jquant.quantize_params(jp, pol),
                              tp if pol is None
                              else tquant.quantize_params(tp, pol))
    return out


@pytest.mark.parametrize("deg", DEGREES, ids=lambda d: "tp%dpp%dfsdp%d" % d)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_serving_specs_equal_jax(trees, family, deg):
    """``serving_param_specs`` equals JAX's, and so does each weight
    policy's tree through ``quantize_specs`` (with the quantized params,
    and without: every projection int8)."""
    kw = FAMILIES[family]
    jcfg, tcfg = jtiny(**kw), ttiny(**kw)
    jspecs = jshard.serving_param_specs(jcfg, _par(JPar, deg))
    tspecs = tshard.serving_param_specs(tcfg, _par(TPar, deg))
    assert _flat(tspecs) == _flat(jspecs)
    assert _flat(tquant.quantize_specs(tspecs)) == \
        _flat(jquant.quantize_specs(jspecs))
    for pol in POLICIES:
        jq, tq = trees[family, pol]
        want = _flat(jquant.quantize_specs(jspecs, jq))
        assert _flat(tquant.quantize_specs(tspecs, tq)) == want, pol
        assert _flat(tshard.serving_specs_of(tcfg, _par(TPar, deg), tq)) \
            == want, pol


@pytest.mark.parametrize("deg", DEGREES, ids=lambda d: "tp%dpp%dfsdp%d" % d)
@pytest.mark.parametrize("cache", ["none", "int8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_kv_pool_specs_equal_jax(devices, family, cache, deg):
    """``kv_pool_specs`` and ``serving_head_axes`` equal JAX's over JAX's
    mesh of the same shape; ``kv_local_dims`` is the specs' local
    shape."""
    kw = dict(FAMILIES[family], kv_cache_quant=cache)
    jcfg, tcfg = jtiny(**kw), ttiny(**kw)
    jmeshed = jmesh.build_mesh(_par(JPar, deg),
                               devices=devices[:int(np.prod(deg))])
    tmeshed = shape_mesh(_par(TPar, deg))
    assert _flat({"s": tshard.kv_pool_specs(tcfg, tmeshed)}) == \
        _flat({"s": jshard.kv_pool_specs(jcfg, jmeshed)})
    assert tshard.serving_head_axes(tcfg, tmeshed) == \
        jshard.serving_head_axes(jcfg, jmeshed)
    tp, pp, _ = deg
    heads = tcfg.kv_heads // tp if tcfg.kv_heads % tp == 0 else tcfg.kv_heads
    assert tshard.kv_local_dims(tcfg, tmeshed) == (tcfg.num_layers // pp,
                                                   heads)


def test_shard_kv_pool_cuts_the_specs_block():
    """``shard_kv_pool`` keeps this rank's slice: half the layers at pp =
    2, half the kv heads at tp = 2, the int8 scale leaf alike."""
    cfg = ttiny(**dict(LLAMA, kv_cache_quant="int8"))
    k, v = tm.init_kv_pool(cfg, 5, 4, device="cpu")
    mesh = shape_mesh(TPar(tensor_parallel=2, pipeline_parallel=2))
    ks, vs = tshard.shard_kv_pool(k, v, cfg, mesh)
    assert tuple(ks["q"].shape) == (1, 5, 4, 4, cfg.head_dim)
    assert tuple(vs["scale"].shape) == (1, 5, 4, 4)


def test_serving_geometry_guard_names_the_axis():
    """Each axis fails on its own message (JAX's
    ``test_pp_geometry_guard_names_the_axis``): layers that do not divide
    pp, heads that do not divide tp (Falcon-7B's 71 at tp = 2), a hidden
    or a padded vocab that the fsdp split does not divide."""
    bad = ttiny(num_layers=3, max_position_embeddings=128)
    with pytest.raises(ValueError, match="layer stack over pp"):
        build_sharded_engine(bad, tm.init_params(bad, 0, device="cpu"),
                             EngineConfig(max_batch_size=2, max_seq_len=64),
                             TPar(pipeline_parallel=2), device="cpu")
    falcon = tconfig.falcon_config("7b")
    assert falcon.num_attention_heads == 71
    with pytest.raises(ValueError, match="attention heads over tp = 2"):
        tshard.assert_serving_geometry(falcon, TPar(tensor_parallel=2))
    tshard.assert_serving_geometry(tconfig.llama2_config("7b"),
                                   TPar(tensor_parallel=2))
    with pytest.raises(ValueError, match="hidden_size"):
        tshard.assert_serving_geometry(ttiny(**LLAMA), TPar(fsdp=3))
    with pytest.raises(ValueError, match="padded vocab"):
        tshard.assert_serving_geometry(
            ttiny(**dict(LLAMA, hidden_size=192, num_attention_heads=6,
                         num_kv_heads=6, make_vocab_size_divisible_by=1,
                         vocab_size=250)), TPar(fsdp=3))


def test_degree_one_returns_the_plain_engine():
    """At pp·tp·fsdp == 1 ``build_sharded_engine`` returns the plain
    engine (no mesh, the fused routes as they were) with its rebuild
    recipe, and it serves the plain engine's tokens; ``build_cluster`` at
    degree 1 serves them through the router, while the disaggregated
    cluster still raises naming item 11 (c)."""
    cfg = ttiny(**LLAMA)
    params = tm.init_params(cfg, 0, device="cpu")
    ec = EngineConfig(max_batch_size=2, max_seq_len=64, prefill_bucket=8)
    eng = build_sharded_engine(cfg, params, ec, device="cpu")
    assert type(eng) is ServingEngine and eng.mesh is None
    assert eng.rebuild_spec["parallel"] == TPar()
    prompt = [5, 9, 13, 2, 7]
    got = eng.submit(prompt, 5, use_eos_stop=False).result(120).tokens
    eng.shutdown()
    plain = ServingEngine(cfg, params, ec, device="cpu")
    want = plain.submit(prompt, 5, use_eos_stop=False).result(120).tokens
    plain.shutdown()
    assert got == want
    router = build_cluster(cfg, params, ec, device="cpu")
    try:
        assert len(router.replicas) == 1
        assert router.replicas[0].engine.mesh is None
        routed = router.submit(prompt, 5, use_eos_stop=False).result(120)
    finally:
        router.shutdown()
    assert routed.tokens == want
    with pytest.raises(NotImplementedError, match=r"item 11 \(c\)"):
        build_disagg_cluster(cfg, params)


@pytest.mark.parametrize("deg", DEGREES + [(1, 1, 1)],
                         ids=lambda d: "tp%dpp%dfsdp%d" % d)
def test_fused_routes_decline_a_sharding_mesh(deg):
    """The whole-stack kernels (K12-K14) decline a mesh that splits the
    stack, as JAX's ``_mesh_shards_stack`` does; a one-rank mesh keeps
    them."""
    mesh = shape_mesh(_par(TPar, deg))
    split = int(np.prod(deg)) > 1
    assert mesh_shards_stack(mesh) == split
    cfg = dataclasses.replace(tconfig.llama2_config(
        "7b", hidden_size=256, num_attention_heads=2, num_layers=2,
        ffn_hidden_size=512, vocab_size=256, params_dtype="float32"))
    params = tm.init_params(cfg, 0, device="meta")
    k, _ = tm.init_kv_pool(cfg, 9, 16, device="meta")
    assert fused_paged_decode_eligible(cfg, params, k, 4, 4)
    assert fused_paged_decode_eligible(cfg, params, k, 4, 4,
                                       mesh=mesh) == (not split)
