"""Pipeline with context parallelism (pp x cp): each stage's ring over
its own cp group, in gloo worlds of 4 (pp 2 x cp 2) and 8 (dp 2 x cp 2 x
pp 2) CPU ranks, against the JAX package (mirror of
``tests/parallel/test_ring_attention.py::
test_train_step_with_context_parallelism``'s pipeline cases).

- the pipelined loss and the gathered grads of one step's microbatches
  (each rank its block of the sequence, the denominators counted over the
  whole) against JAX's unsharded mean over the microbatches: the loss at
  JAX's limit for these cases (1e-3; the port lands far inside it), the
  grads at the pipeline tests' limits (rtol 5e-4, atol 5e-5);
- the pipelined evaluation's loss and metrics (the per-token values
  gathered over cp) against JAX's pipelined eval step;
- two steps of ``pretrain`` at pp 2 x cp 2 against JAX's driver at the
  same degrees, and ``finetune --pp 2 --cp 2`` against the same run in
  one process;
- JAX's own refusal, zigzag under pp, stays.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny

import test_torch_pipeline as tp
import torch_world

torch.set_num_threads(1)

JAX_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
KW = tp._model_kw(4)
FINETUNE = ["--model", "tiny", "--mock_data", "--train_iters", "3",
            "--device", "cpu", "--log_interval", "1", "--seq_length", "32",
            "--micro_batch_size", "2", "--global_batch_size", "4",
            "--eval_iters", "1", "--eval_interval", "2",
            "--params_dtype", "float32"]
TRAIN = dict(train_iters=2, micro_batch_size=2, global_batch_size=4,
             seq_length=32, log_interval=1)


def _meta(dp=1, M=2, **extra):
    meta = tp._meta(KW, dp=dp, M=M, **extra)
    meta["parallel"]["context_parallel"] = 2
    return meta


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    jobs4 = [("pipeline_case", {"params": tp._jparams(KW),
                                "batch": tp._batch(KW, 2, 2, seed=3,
                                                   mixed=True)}, _meta()),
             ("pipeline_case", {"params": tp._jparams(KW),
                                "batch": tp._batch(KW, 4, 2, seed=7,
                                                   mixed=True)},
              _meta(M=4, metrics=tp.METRICS)),
             ("pretrain_case", {"params": tp._jparams(KW),
                                "batches": _train_batches()},
              dict(model=("tiny_config", KW),
                   parallel=dict(pipeline_parallel=2, context_parallel=2,
                                 num_microbatches=2),
                   optimizer=dict(lr=1e-3, clip_grad=1.0), train=TRAIN)),
             ("entry_case", {}, dict(entry="finetune", argv=FINETUNE + [
                 "--pp", "2", "--cp", "2"]))]
    out.update(zip(["pp2_cp2", "eval", "train", "finetune"],
                   torch_world.run_world(4, tmp_path_factory.mktemp("w4"),
                                         jobs4)))
    jobs8 = [("pipeline_case", {"params": tp._jparams(KW),
                                "batch": tp._batch(KW, 2, 4, seed=3,
                                                   mixed=True)},
              _meta(dp=2))]
    out.update(zip(["dp2_cp2_pp2"], torch_world.run_world(
        8, tmp_path_factory.mktemp("w8"), jobs8)))
    return out


def _train_batches():
    g = np.random.default_rng(5)
    out = {}
    for i in range(2):
        toks = g.integers(0, 256, (2, 2, 32))
        out[str(i)] = {"tokens": toks.astype(np.int64),
                       "labels": np.roll(toks, -1, -1).astype(np.int64),
                       "loss_mask": np.ones((2, 2, 32), np.float32)}
    return out


def _jax_reference(batch):
    """JAX's unsharded mean over the microbatches of the LM loss, and its
    grads."""
    rt = JRun(model=jtiny(**KW), optimizer=JOpt(),
              train=JTrain(seq_length=32)).validate()
    M = batch["tokens"].shape[0]

    def loss_of(p):
        return sum(jstep.compute_loss(rt, p, {k: jnp.asarray(v[m]) for k, v
                                              in batch.items()})
                   for m in range(M)) / M

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree.map(jnp.asarray, tp._jparams(KW)))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name,dp", [("pp2_cp2", 1), ("dp2_cp2_pp2", 2)])
def test_pipeline_with_ring_matches_jax(worlds, name, dp):
    """pp 2 x cp 2, and the manual triple dp 2 x cp 2 x pp 2: the loss and
    every gathered grad equal JAX's unsharded ones (the ring's online
    softmax and the cp sums reorder fp32 additions alone)."""
    loss, grads = _jax_reference(tp._batch(KW, 2, 2 * dp, seed=3,
                                           mixed=True))
    out = worlds[name]
    np.testing.assert_allclose(float(out["loss"]), loss, **JAX_LOSS_TOL)
    np.testing.assert_allclose(float(out["loss"]), loss, **tp.LOSS_TOL)
    flat = torch_world.flatten(out["grads"])
    for k, w in torch_world.flatten(grads).items():
        np.testing.assert_allclose(flat[k], w, **tp.GRAD_TOL, err_msg=k)


def test_pipeline_eval_with_ring_matches_jax(worlds):
    """The pipelined evaluation under cp: the loss summed and the metrics'
    per-token values gathered over cp equal JAX's eval step's (its
    limits)."""
    batch = tp._batch(KW, 4, 2, seed=7, mixed=True)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    want = jax.device_get(jdriver.make_eval_step(
        JRun(model=jtiny(**KW), optimizer=JOpt(),
             train=JTrain(seq_length=32, metrics=tp.METRICS)),
        tp.METRICS)(jax.tree.map(jnp.asarray, tp._jparams(KW)), flat))
    got = worlds["eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **tp.METRIC_TOL, err_msg=k)


def test_pretrain_pp2_cp2_matches_jax(worlds, capsys):
    """Two steps of the port's ``pretrain`` at pp 2 x cp 2 log JAX's
    driver's losses at the same degrees (JAX's pipeline with the ring
    inside, on its CPU mesh)."""
    jc = JRun(model=jtiny(**KW), parallel=JPar(
        pipeline_parallel=2, context_parallel=2, num_microbatches=2),
        optimizer=JOpt(lr=1e-3, clip_grad=1.0),
        train=JTrain(**TRAIN)).validate()
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _train_batches().items()}
    capsys.readouterr()

    def provider(consumed, gbs):
        i = consumed // gbs
        while True:
            yield batches[str(i)]
            i += 1

    jdriver.pretrain(jc, params=jax.tree.map(jnp.asarray, tp._jparams(KW)),
                     batch_provider=provider)
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|",
                                         capsys.readouterr().out)]
    got = worlds["train"]["losses"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_finetune_pp2_cp2_equals_one_process(worlds, capsys):
    """``finetune --pp 2 --cp 2`` in a world of four logs the one-process
    run's losses and validation losses (fp32)."""
    capsys.readouterr()
    assert tfinetune.main(FINETUNE) == 0
    out = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]
    valid = [float(x) for x in re.findall(
        r"validation loss at .*? lm_loss: ([0-9.E+-]+) \|", out)]
    got = worlds["finetune"]
    assert len(want) == len(got["losses"]) == 3 and len(valid) >= 1
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    np.testing.assert_allclose(got["valid"], valid, rtol=1e-5)


def test_zigzag_under_pp_is_jax_own_refusal():
    """JAX ``config.py:494-498``: the zigzag layout is not plumbed through
    the pipeline schedule."""
    with pytest.raises(ValueError, match="zigzag"):
        TRun(model=ttiny(num_layers=4), parallel=TPar(
            pipeline_parallel=2, context_parallel=2,
            context_parallel_layout="zigzag"),
            train=TTrain(seq_length=32)).validate()
