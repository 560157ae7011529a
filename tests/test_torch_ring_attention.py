"""Context parallelism: the port's ring attention (contiguous and zigzag)
and its training and eval steps in gloo worlds of 2 and 4 CPU ranks
against the JAX package (mirror of
``tests/parallel/test_ring_attention.py``).

Each world (``tests/torch_world.py``) runs every case of the module once;
JAX's ring runs in the pytest process on its forced CPU devices.  The
limits are JAX's own: the ring's output 1e-5, its gradients 1e-4, the
train losses 1e-4, the eval loss 1e-5.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops.attention import dot_product_attention as jdot
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu.parallel import ring_attention as jring
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch.parallel import ring_attention as tring

import test_torch_parallel as tp2
import torch_world

torch.set_num_threads(1)

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
SEG = np.stack([np.r_[[0] * 10, [1] * 22], np.r_[[0] * 20, [1] * 12]])
# (cp, causal, zigzag, segments)
RING = {"causal_cp2": (2, True, False, False),
        "causal_cp4": (4, True, False, False),
        "noncausal_cp4": (4, False, False, False),
        "segments_cp4": (4, True, False, True),
        "zigzag_cp2": (2, True, True, False),
        "zigzag_cp4": (4, True, True, False),
        "zigzag_segments_cp4": (4, True, True, True)}
MODEL = dict(vocab_size=64, seq_length=32, max_position_embeddings=32)
STEP_TRAIN = dict(seq_length=32, micro_batch_size=2, global_batch_size=4,
                  train_iters=2, log_interval=1)
OPT = dict(lr=1e-3, clip_grad=1.0)
# train steps: (dp, cp, layout) in a world of 4
STEPS = {"dp2_cp2": (2, 2, "contiguous"), "dp2_cp2_zigzag": (2, 2, "zigzag")}


def _qkv(seed, b=2, s=32, nq=4, nkv=2, d=8):
    g = np.random.default_rng(seed)
    return {"q": g.normal(size=(b, s, nq, d)).astype(np.float32),
            "k": g.normal(size=(b, s, nkv, d)).astype(np.float32),
            "v": g.normal(size=(b, s, nkv, d)).astype(np.float32),
            "w": g.normal(size=(b, s, nq, d)).astype(np.float32)}


def _ring_inputs(name):
    cp, causal, zigzag, seg = RING[name]
    tree = _qkv(sum(map(ord, name)))
    if seg:
        tree["seg"] = SEG.astype(np.int64)
    return tree


def _batches(seed=7, n=2):
    g = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        toks = g.integers(0, 64, (1, 4, 32))
        out[str(i)] = {"tokens": toks.astype(np.int64),
                       "labels": np.roll(toks, -1, -1).astype(np.int64),
                       "loss_mask": np.ones((1, 4, 32), np.float32)}
    return out


def _provider(batches):
    def provider(consumed, gbs):
        i = consumed // gbs
        while True:
            yield batches[str(i)]
            i += 1
    return provider


def _jparams(seed=3):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed),
                                                   jtiny(**MODEL)))


def _eval_batch():
    g = np.random.default_rng(21)
    toks = g.integers(0, 64, (4, 32))
    return {"tokens": toks.astype(np.int64),
            "labels": np.roll(toks, -1, -1).astype(np.int64),
            "loss_mask": (g.random((4, 32)) > 0.2).astype(np.float32)}


CP_TP = tp2._model_kw(tp2.LLAMA, 2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        jobs, names = [], []
        for name, (cp, causal, zigzag, _) in RING.items():
            if cp == world:
                jobs.append(("ring_case", _ring_inputs(name),
                             dict(causal=causal, zigzag=zigzag)))
                names.append(name)
        jobs.append(("ppermute_case", _permute_inputs(world),
                     dict(dir=str(tmp_path_factory.mktemp(f"pbox{world}")))))
        names.append(f"ppermute_{world}")
        if world == 4:
            for name, (dp, cp, layout) in STEPS.items():
                jobs.append(("pretrain_case",
                             {"params": _jparams(), "batches": _batches()},
                             dict(model=("tiny_config", MODEL),
                                  parallel=dict(
                                      data_parallel=dp, context_parallel=cp,
                                      context_parallel_layout=layout),
                                  optimizer=OPT, train=STEP_TRAIN)))
                names.append(name)
            jobs.append(("grads_case",
                         {"params": tp2._jparams(tp2.LLAMA),
                          "batch": tp2._batch(256)},
                         dict(model=("tiny_config", CP_TP),
                              parallel=dict(context_parallel=2,
                                            tensor_parallel=2,
                                            sequence_parallel=True),
                              train=dict(seq_length=tp2.SEQ,
                                         micro_batch_size=4,
                                         global_batch_size=4))))
            names.append("cp2_tp2_sp")
            jobs.append(("eval_case", {"params": _jparams(),
                                       "batch": _eval_batch()},
                         dict(model=("tiny_config", MODEL),
                              parallel=dict(context_parallel=4,
                                            context_parallel_layout="zigzag"),
                              train=dict(seq_length=32, micro_batch_size=4,
                                         global_batch_size=4),
                              metrics=["perplexity", "accuracy"])))
            names.append("eval_zigzag_cp4")
        tmp = tmp_path_factory.mktemp(f"ring{world}")
        out.update(zip(names, torch_world.run_world(world, tmp, jobs)))
    return out


def _permute_inputs(world):
    g = np.random.default_rng(world)
    return {"x": g.normal(size=(world, 5, 7)).astype(np.float32),
            "w": g.normal(size=(world, 5, 7)).astype(np.float32)}


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_forward_backward_and_refusals(worlds, world):
    """``mappings.ppermute`` over gloo: the identity keeps each rank's
    tensor, a rotation moves rank r's to r + 1 and a partial permutation
    ``(0, n - 1)`` leaves zeros where nothing arrives; each backward
    sends the grads the reverse way (rank r's grad is the receiver's
    weight).  The mailbox's point-to-point exchange (shared host memory,
    in pieces) equals gloo's, and a non-permutation or an NCCL group's
    CPU tensor raises."""
    out = worlds[f"ppermute_{world}"]
    t = _permute_inputs(world)
    x, w, n = t["x"], t["w"], world
    rot = np.roll(x, 1, axis=0)
    part = np.zeros_like(x)
    part[n - 1] = x[0]
    np.testing.assert_array_equal(out["identity_out"], x)
    np.testing.assert_array_equal(out["identity_grad"], w)
    np.testing.assert_array_equal(out["rotation_out"], rot)
    np.testing.assert_array_equal(out["rotation_grad"], np.roll(w, -1, 0))
    np.testing.assert_array_equal(out["partial_out"], part)
    grad = np.zeros_like(w)
    grad[0] = w[n - 1]
    np.testing.assert_array_equal(out["partial_grad"], grad)
    assert bool(out["mailbox_equal"])
    np.testing.assert_array_equal(out["mailbox_partial"], part)
    assert str(out["refused"]) == "not_a_permutation,nccl_cpu"


def _cp_mesh(cp):
    devs = np.asarray(jax.devices()[:8]).reshape(8 // cp, 1, 1, cp, 1, 1, 1)
    return Mesh(devs, jmesh.AXIS_ORDER)


def _jax_ring(name):
    """JAX's ring output and the grads of ``sum(out * w)``."""
    cp, causal, zigzag, seg = RING[name]
    t = _ring_inputs(name)
    mesh = _cp_mesh(cp)
    q, k, v, w = (jnp.asarray(t[x]) for x in "qkvw")
    s = jnp.asarray(t["seg"]) if seg else None
    n = q.shape[1]
    pi = jring.zigzag_indices(n, cp) if zigzag else np.arange(n)
    inv = np.argsort(pi)

    def out(q_, k_, v_):
        args = (q_[:, pi], k_[:, pi], v_[:, pi])
        sg = None if s is None else s[:, pi]
        if zigzag:
            o = jring.ring_attention_zigzag(*args, mesh=mesh, segment_ids=sg)
        else:
            o = jring.ring_attention(*args, mesh=mesh, causal=causal,
                                     segment_ids=sg)
        return o[:, inv]

    o = jax.jit(out)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(out(*a) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    ref = jdot(q, k, v, causal=causal, segment_ids=s)
    return np.asarray(o), [np.asarray(g) for g in grads], np.asarray(ref)


@pytest.mark.parametrize("name", list(RING))
def test_ring_matches_jax(worlds, name):
    """The ring's output equals dot-product attention and JAX's ring, and
    its dQ, dK, dV (the backward ring: K/V rotated again, dK/dV travelling
    with their blocks) equal JAX's ring gradients."""
    got = worlds[name]
    want, grads, dot = _jax_ring(name)
    np.testing.assert_allclose(got["out"], dot, **OUT_TOL)
    np.testing.assert_allclose(got["out"], want, **OUT_TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], g, **GRAD_TOL,
                                   err_msg=f"{name}: {key}")


def test_zigzag_indices_equal_jax():
    for s, cp in [(32, 4), (64, 8), (48, 2)]:
        np.testing.assert_array_equal(tring.zigzag_indices(s, cp),
                                      jring.zigzag_indices(s, cp))
        np.testing.assert_array_equal(tring.inverse_zigzag_indices(s, cp),
                                      jring.inverse_zigzag_indices(s, cp))
    with pytest.raises(ValueError, match="2\\*cp"):
        tring.zigzag_indices(30, 4)


def _jax_driver_losses(dp, cp, layout, capsys):
    jc = JRun(model=jtiny(**MODEL),
              parallel=JPar(data_parallel=dp, context_parallel=cp,
                            context_parallel_layout=layout),
              optimizer=JOpt(**OPT), train=JTrain(**STEP_TRAIN)).validate()
    params = jm.init_params(jax.random.key(3), jc.model)
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _batches().items()}
    capsys.readouterr()
    jdriver.pretrain(jc, params=params, batch_provider=_provider(batches))
    out = capsys.readouterr().out
    return [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_with_context_parallelism(worlds, name, capsys):
    """Two steps of the port's ``pretrain`` at dp = 2 x cp = 2
    (contiguous and zigzag) log JAX's driver's losses at the same
    degrees, and those of cp = 1 (JAX's limit, 1e-4)."""
    dp, cp, layout = STEPS[name]
    got = worlds[name]["losses"]
    want = _jax_driver_losses(dp, cp, layout, capsys)
    ref = _jax_driver_losses(dp, 1, "contiguous", capsys)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_cp_with_tensor_and_sequence_parallelism(worlds):
    """cp = 2 x tp = 2 with sequence parallelism: one microbatch's loss
    and whole grads equal JAX's unsharded ones (the ring runs each
    rank's heads; the dropout-free residual stream holds its cp, then tp,
    block of the sequence)."""
    out = worlds["cp2_tp2_sp"]
    loss, grads = tp2._jax_loss_grads(tp2.LLAMA, False, tp2._batch(256),
                                      None)
    np.testing.assert_allclose(float(out["loss"]), loss, **tp2.LOSS_TOL)
    tp2._assert_grads(out["grads"], grads, "cp=2 tp=2 sp vs JAX")


def test_eval_step_with_zigzag_layout(worlds):
    """The eval step permutes its batch as the train step does: at cp = 4
    zigzag its loss and metrics equal JAX's zigzag eval step and the
    unsharded one (1e-5)."""
    out = worlds["eval_zigzag_cp4"]
    batch = _eval_batch()
    params = _jparams()
    metrics = ("perplexity", "accuracy")
    res = {}
    for cp, layout in ((1, "contiguous"), (4, "zigzag")):
        cfg = JRun(model=jtiny(**MODEL),
                   parallel=JPar(context_parallel=cp,
                                 context_parallel_layout=layout),
                   optimizer=JOpt(),
                   train=JTrain(seq_length=32, micro_batch_size=4,
                                global_batch_size=4)).validate()
        mesh = jmesh.build_mesh(cfg.parallel)
        step = jdriver.make_eval_step(cfg, metrics, mesh)
        with jmesh.use_mesh(mesh):
            res[cp] = jax.device_get(step(params, {
                k: jnp.asarray(v) for k, v in batch.items()}))
    for k in ("lm_loss",) + metrics:
        for cp in (1, 4):
            np.testing.assert_allclose(out[k], res[cp][k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} cp={cp}")


def test_attention_dispatch_takes_the_ring_and_refuses_bias():
    """``ops.attention.attention`` with ``cp_axis`` takes the ring whatever
    ``impl`` says; a bias or attention dropout raises (no fallback)."""
    from megatron_llm_tpu_torch.ops import attention as tattn

    from megatron_llm_tpu_torch.parallel import mappings

    t = {k: torch.from_numpy(v) for k, v in _qkv(0).items()}
    before = mappings.launches
    got = tattn.attention(t["q"], t["k"], t["v"], impl="flash",
                          cp_axis="cp", mesh=_one_rank_mesh())
    want = tattn.dot_product_attention(t["q"], t["k"], t["v"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert mappings.launches == before  # a group of one rotates nothing
    with pytest.raises(ValueError, match="bias or attention dropout"):
        tattn.attention(t["q"], t["k"], t["v"], cp_axis="cp",
                        dropout_rate=0.1, mesh=_one_rank_mesh())
    with pytest.raises(ValueError, match="causal-only"):
        tattn.attention(t["q"], t["k"], t["v"], cp_axis="cp", causal=False,
                        cp_zigzag=True, mesh=_one_rank_mesh())


def _one_rank_mesh():
    from megatron_llm_tpu_torch.parallel import mesh as tmesh

    return tmesh.single_device_mesh()
