"""Tensor and sequence parallelism of the port against the JAX package, in a
world of two CPU ranks (mirror of ``tests/parallel/test_tensor_parallel.py``
and ``test_cross_entropy.py`` at their tolerances).

The ranks (``tests/torch_world.py``, spawned once for the module, gloo
over a ``file://`` rendezvous) cut JAX's weights to their shards and run
the port's loss and backward with the collectives of
``parallel/mappings.py``; rank 0 gathers the grads.  The pytest process
computes JAX's side: the unsharded step and JAX's own tp = 2 step on the
conftest's host devices.  Cases: Llama at tp = 2 with and without
sequence parallelism (and once through the kernels' plain versions with
selective recompute), Falcon's MQA (one kv head, replicated) and GPT
(LayerNorm, biases, learned positions, a padded vocabulary) at tp = 2
with sequence parallelism, vocab-parallel CE and greedy ids against
``vocab_parallel_cross_entropy_shardmap``, dropout at tp = 2 against the
port at tp = 1 with the same key, the spec trees against JAX's, and a
rendezvous without its peer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.models import sharding as jshard
from megatron_llm_tpu.parallel import cross_entropy as jce
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import sharding as tshard
from megatron_llm_tpu_torch.ops import dropout as tdrop
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_map

import torch_world

torch.set_num_threads(1)

SEQ = 32
# JAX tests/parallel/test_tensor_parallel.py:_model_cfg
LLAMA = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
             num_kv_heads=8, ffn_hidden_size=128, vocab_size=256,
             params_dtype="float32", recompute="none", seq_length=SEQ,
             max_position_embeddings=SEQ)
FALCON = dict(LLAMA, norm_type="layernorm", activation="gelu_exact",
              parallel_attn=True, num_kv_heads=1, tie_embed_logits=True)
GPT = dict(LLAMA, norm_type="layernorm", activation="gelu",
           position_embedding_type="absolute", use_bias=True,
           tie_embed_logits=True, num_kv_heads=None, vocab_size=250)
KERNELS = dict(LLAMA, attention_impl="flash", norm_impl="pallas",
               recompute="selective", num_kv_heads=4)

TP = 2
# name: (model kwargs, sequence parallel[, micro batch]); at b 1 the
# sequence-major views of the activations are contiguous, so a collective
# that wrote its input in place would corrupt a shared grad
CASES = {
    "llama": (LLAMA, False),
    "llama_sp": (LLAMA, True),
    "llama_kernels_sp_b1": (KERNELS, True, 1),
    "falcon_mqa_sp": (FALCON, True),
    "gpt_sp": (GPT, True),
    "llama_gqa_kernels_sp": (KERNELS, True),
}
DROPOUT = dict(GPT, hidden_dropout=0.1, attention_dropout=0.1)
CE = [(0.0, None), (0.1, 250)]   # (label smoothing, vocab size)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-5, atol=1e-5)


def _model_kw(kw, tp=TP):
    return dict(kw, make_vocab_size_divisible_by=8 * tp)


def _batch(vocab, b=4, seed=3):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, vocab, (b, SEQ)).astype(np.int64),
            "labels": g.integers(0, vocab, (b, SEQ)).astype(np.int64),
            "loss_mask": (g.random((b, SEQ)) > 0.2).astype(np.float32)}


def _jparams(kw, tp=TP):
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(0), jtiny(**_model_kw(kw, tp)), tp=tp))


def _meta(kw, sp, tp=TP, **extra):
    return dict(model=("tiny_config", _model_kw(kw, tp)),
                parallel=dict(tensor_parallel=tp, sequence_parallel=sp),
                train=dict(seq_length=SEQ), **extra)


def _ce_inputs(seed=0):
    g = np.random.default_rng(seed)
    return (g.normal(size=(2, 8, 256)).astype(np.float32) * 3,
            g.integers(0, 250, (2, 8)).astype(np.int64))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the module in one world of two ranks."""
    jobs, names = [], []
    for name, (kw, sp, *b) in CASES.items():
        jobs.append(("grads_case", {"params": _jparams(kw),
                                    "batch": _batch(kw["vocab_size"], *b)},
                     _meta(kw, sp)))
        names.append(name)
    jobs.append(("grads_case", {"params": _jparams(DROPOUT),
                                "batch": _batch(250)},
                 _meta(DROPOUT, True, seed=7)))
    names.append("dropout_sp")
    jobs.append(("mailbox_case", {"x": np.random.default_rng(5).integers(
        -50, 50, (TP, 37, 61)).astype(np.float32)},
        dict(dir=str(tmp_path_factory.mktemp("boxes")))))
    names.append("mailbox")
    logits, targets = _ce_inputs()
    for smoothing, vocab in CE:
        jobs.append(("ce_case", {"logits": logits, "targets": targets},
                     dict(tp=TP, smoothing=smoothing, vocab_size=vocab)))
        names.append(f"ce_{smoothing}_{vocab}")
    outs = torch_world.run_world(TP, tmp_path_factory.mktemp("tp2"), jobs)
    return dict(zip(names, outs))


def _jax_loss_grads(kw, sp, batch, tp):
    """JAX's loss and grads of ``batch``: unsharded (``tp`` None) or on
    its tp mesh (JAX test_tp_loss_and_grads_match_unsharded)."""
    cfg = jtiny(**_model_kw(kw))
    params = jm.init_params(jax.random.key(0), cfg, tp=TP)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    par = JPar() if tp is None else JPar(tensor_parallel=tp,
                                         sequence_parallel=sp)
    rt = JRun(model=cfg, parallel=par, optimizer=JOpt(),
              train=JTrain(seq_length=SEQ)).validate()
    fn = jax.jit(jax.value_and_grad(lambda p: jstep.compute_loss(rt, p, jb)))
    if tp is None:
        loss, grads = fn(params)
    else:
        mesh = jmesh.build_mesh(par)
        sharded = jshard.shard_params(params, jshard.param_specs(cfg, par),
                                      mesh)
        with jmesh.use_mesh(mesh):
            loss, grads = fn(sharded)
    return float(loss), jax.tree.map(np.asarray, grads)


def _assert_grads(got, want, what):
    flat_w = dict(torch_world.flatten(want))
    flat_g = dict(torch_world.flatten(got))
    assert sorted(flat_w) == sorted(flat_g)
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], w, **GRAD_TOL,
                                   err_msg=f"{what}: grad {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_loss_and_grads_match_jax(world, name):
    """The port at tp = 2 against JAX unsharded, and (Llama) against JAX's
    own tp = 2 step with the same sequence parallelism."""
    kw, sp, *b = CASES[name]
    out = world[name]
    batch = _batch(kw["vocab_size"], *b)
    ref_loss, ref_grads = _jax_loss_grads(kw, sp, batch, None)
    np.testing.assert_allclose(float(out["loss"]), ref_loss, **LOSS_TOL)
    _assert_grads(out["grads"], ref_grads, f"{name} vs JAX unsharded")
    if name in ("llama", "llama_sp"):
        tp_loss, tp_grads = _jax_loss_grads(kw, sp, batch, TP)
        np.testing.assert_allclose(float(out["loss"]), tp_loss, **LOSS_TOL)
        _assert_grads(out["grads"], tp_grads, f"{name} vs JAX tp={TP}")


def test_dropout_at_tp2_equals_tp1(world):
    """Hidden and attention dropout 0.1 at tp = 2 with sequence
    parallelism drop what the one-device run drops with the same key:
    each rank keeps its block of the mask drawn at the global shape."""
    out = world["dropout_sp"]
    cfg = TRun(model=ttiny(**_model_kw(DROPOUT)),
               train=TTrain(seq_length=SEQ)).validate()
    params = params_from_jax(_jparams(DROPOUT), device="cpu")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(250).items()}
    loss = tstep.compute_loss(cfg, live, batch, rng=tdrop.key(7))
    loss.backward()
    no_drop = tstep.compute_loss(cfg, params, batch)
    assert abs(float(loss.detach()) - float(no_drop)) > 1e-3  # dropout on
    np.testing.assert_allclose(float(out["loss"]), float(loss.detach()),
                               **LOSS_TOL)
    _assert_grads(out["grads"], tree_map(lambda p: p.grad.numpy(), live),
                  "dropout tp=2 vs tp=1")


@pytest.mark.parametrize("smoothing,vocab", CE)
def test_vocab_parallel_ce_matches_shardmap(world, smoothing, vocab):
    """Per-token CE, its gradient and the greedy ids over vocab shards
    against JAX's ``vocab_parallel_cross_entropy_shardmap`` on a tp = 2
    mesh (label smoothing, padded columns masked)."""
    out = world[f"ce_{smoothing}_{vocab}"]
    logits, targets = _ce_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:TP]), ("tp",))

    def f(lg):
        return jce.vocab_parallel_cross_entropy_shardmap(
            lg, jnp.asarray(targets, jnp.int32), mesh,
            label_smoothing=smoothing, vocab_size=vocab)

    want, vjp = jax.vjp(f, jnp.asarray(logits))
    (grad,) = vjp(jnp.ones_like(want))
    np.testing.assert_allclose(out["loss"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["grad"], np.asarray(grad), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        out["argmax"], np.asarray(jce.vocab_parallel_max_indices(logits)))


@pytest.mark.parametrize("family,kw", [
    ("llama", dict(LLAMA, num_kv_heads=4)), ("falcon", FALCON),
    ("gpt", GPT), ("falcon40b", dict(FALCON, parallel_layernorm=True,
                                     num_kv_heads=2))])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_param_specs_equal_jax(family, kw, tp):
    """``param_specs`` equals JAX's tree leaf for leaf (a spec is the
    tuple of a ``PartitionSpec``), with and without sequence
    parallelism."""
    for sp in (False, True):
        jcfg, tcfg = jtiny(**kw), ttiny(**kw)
        jspecs = jshard.param_specs(jcfg, JPar(tensor_parallel=tp,
                                               sequence_parallel=sp))
        tspecs = tshard.param_specs(tcfg, TPar(tensor_parallel=tp,
                                               sequence_parallel=sp))
        assert torch_world.flatten(tspecs) == torch_world.flatten(
            jax.tree.map(tuple, jspecs,
                         is_leaf=lambda x: isinstance(x, jax.sharding
                                                      .PartitionSpec)))
    par = TPar(tensor_parallel=tp, sequence_parallel=True)
    assert tshard.sequence_parallel_spec(par) == tuple(
        jshard.sequence_parallel_spec(JPar(tensor_parallel=tp,
                                           sequence_parallel=True)))
    assert tshard.logits_spec(par) == tuple(jshard.logits_spec(JPar()))
    assert tshard.kv_shard_axes(tcfg, tp) == jshard.kv_shard_axes(jcfg, tp)


def test_sequence_parallel_axis_set_and_cleared():
    """``RuntimeConfig.validate`` wires sequence parallelism into the model
    and clears it again, as JAX config.py:511-519; sequence parallelism
    needs tp > 1 and a sequence that divides."""
    cfg = TRun(model=ttiny(), parallel=TPar(tensor_parallel=2,
                                            sequence_parallel=True),
               train=TTrain(seq_length=SEQ)).validate()
    assert cfg.model.sequence_parallel_axis == "tp"
    again = dataclasses.replace(cfg, parallel=TPar()).validate()
    assert again.model.sequence_parallel_axis is None
    with pytest.raises(ValueError, match="splits seq_length"):
        TRun(model=ttiny(), parallel=TPar(tensor_parallel=2,
                                          sequence_parallel=True),
             train=TTrain(seq_length=33)).validate()
    # fsdp, the serving residency axis, validates (sharded serving);
    # training refuses it, stating JAX's behaviour (a replicated step)
    assert TPar(fsdp=2).validate().world_size == 2
    from megatron_llm_tpu_torch.training import driver as tdriver
    with pytest.raises(ValueError, match="replicates weights and batch"):
        tdriver.setup_train_state(
            TRun(model=ttiny(), parallel=TPar(fsdp=2),
                 train=TTrain(seq_length=SEQ)), device="cpu")


def test_rendezvous_without_its_peer_raises():
    """A rank of a world of two whose peer never comes raises within the
    timeout: it never goes on to train alone."""
    import datetime
    import socket
    import time

    from megatron_llm_tpu_torch import initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        initialize.initialize_distributed(
            "cpu", init_method=f"tcp://127.0.0.1:{port}", rank=1,
            world_size=2, timeout=datetime.timedelta(seconds=3))
    assert time.perf_counter() - t0 < 60
    assert not initialize.is_initialized()
    assert not torch.distributed.is_initialized()


def test_the_mesh_is_current_in_other_threads():
    """The backward of a CUDA tensor runs on autograd's device thread, and
    a layer recomputed there must see the forward's mesh: ``use_mesh``
    holds one stack for the process."""
    import threading

    from megatron_llm_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.single_device_mesh()
    seen = []
    with tmesh.use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(tmesh.current_mesh()))
        t.start()
        t.join()
    assert seen == [mesh] and tmesh.current_mesh() is None


@pytest.mark.parametrize("dp,zero", [(2, True), (4, True), (2, False)])
def test_zero1_specs_equal_jax(dp, zero):
    """ZeRO-1's optimizer-state specs (dp on the first unsplit dimension
    dp divides) equal JAX ``zero1_specs`` / ``opt_state_specs`` leaf for
    leaf, at tp = 2 with the padded vocabulary."""
    from megatron_llm_tpu.training import optimizer as jopt
    from megatron_llm_tpu_torch.training import optimizer as topt

    kw = _model_kw(GPT)
    jpar = JPar(data_parallel=dp, tensor_parallel=TP,
                use_distributed_optimizer=zero)
    tpar = TPar(data_parallel=dp, tensor_parallel=TP,
                use_distributed_optimizer=zero)
    jcfg = jtiny(**kw)
    jparams = jm.init_params(jax.random.key(0), jcfg, tp=TP)
    jspecs = jshard.param_specs(jcfg, jpar)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    tspecs = tshard.param_specs(ttiny(**kw), tpar)
    want = jopt.zero1_specs(jspecs, jparams, jpar)
    got = topt.zero1_specs(tspecs, tparams, tpar)
    assert torch_world.flatten(got) == torch_world.flatten(jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding
                                                  .PartitionSpec)))
    state = topt.init_opt_state(tparams, TOpt())
    assert topt.opt_state_specs(tspecs, tparams, tpar, state).mu == got


def test_shared_device_mailbox_equals_gloo(world):
    """The transport of ranks that share one device (``DeviceMailbox``;
    on the card its boxes are CUDA IPC mappings, here shared host
    memory): all-reduce (sum, max) and all-gather in pieces of a 4 KB box
    give gloo's own results (integer-valued floats: any sum order is
    exact), bf16 bits kept."""
    out = world["mailbox"]
    for name in ("sum", "max", "gather"):
        np.testing.assert_array_equal(out[f"{name}_mailbox"],
                                      out[f"{name}_gloo"])
    assert bool(out["gather_bf16_exact"])


def test_mesh_helpers_equal_jax():
    """The mesh's axis order and pure helpers equal JAX's; a rank's
    coordinates are its row-major place in the mesh shape (tp fastest);
    ``fold_in_axis`` keys differ by the rank's index on the axis."""
    from megatron_llm_tpu_torch.parallel import mesh as tmesh

    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert (tmesh.TP_SALT, tmesh.PP_SALT) == (jmesh.TP_SALT, jmesh.PP_SALT)
    for layers, pp, vpp in ((8, 2, 1), (12, 2, 3), (4, 4, 1)):
        assert tmesh.pipeline_stage_layers(layers, pp, vpp) == \
            jmesh.pipeline_stage_layers(layers, pp, vpp)
        assert tmesh.stage_layer_ranges(layers, pp) == \
            jmesh.stage_layer_ranges(layers, pp)
    for stage in range(4):
        assert (tmesh.prev_stage(stage, 4), tmesh.next_stage(stage, 4)) == \
            (jmesh.prev_stage(stage, 4), jmesh.next_stage(stage, 4))
    keys = {tmesh.fold_in_axis(tdrop.key(3), tmesh.Mesh(
        shape={"tp": 2}, coords={"tp": i}, groups={}), "tp") for i in (0, 1)}
    assert len(keys) == 2
    one = tmesh.build_mesh(TPar())
    assert one.groups == {} and all(one.index(a) == 0
                                    for a in tmesh.AXIS_ORDER)
    with pytest.raises(ValueError, match="torchrun"):
        tmesh.build_mesh(TPar(tensor_parallel=2))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_encoder_family_specs_equal_jax(tp):
    """``bert_param_specs``, ``t5_param_specs`` and
    ``biencoder_param_specs`` equal JAX's leaf for leaf (JAX
    ``encdec.py:367-421``, ``biencoder.py:209``)."""
    from megatron_llm_tpu.config import ModelConfig as JModel
    from megatron_llm_tpu.models import biencoder as jbi
    from megatron_llm_tpu.models import encdec as jenc
    from megatron_llm_tpu_torch.config import ModelConfig as TModel
    from megatron_llm_tpu_torch.models import biencoder as tbi
    from megatron_llm_tpu_torch.models import encdec as tenc

    import test_torch_encdec as enc

    def as_tuples(tree):
        return torch_world.flatten(jax.tree.map(
            tuple, tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))

    bert = dict(enc.BASE, tokentype_size=2)
    t5 = dict(enc.BASE, num_decoder_layers=2, num_kv_heads=2)
    jpar, tpar = JPar(tensor_parallel=tp), TPar(tensor_parallel=tp)
    cases = [
        (jenc.bert_param_specs(JModel(**bert), jpar),
         tenc.bert_param_specs(TModel(**bert), tpar)),
        (jenc.t5_param_specs(JModel(**t5), jpar),
         tenc.t5_param_specs(TModel(**t5), tpar))]
    for proj, shared in ((0, False), (16, True), (16, False)):
        cases.append((
            jbi.biencoder_param_specs(JModel(**bert), jpar, proj, shared),
            tbi.biencoder_param_specs(TModel(**bert), tpar, proj, shared)))
    for want, got in cases:
        assert torch_world.flatten(got) == as_tuples(want)
