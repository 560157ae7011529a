"""Pipeline parallelism through the training entry points: a world of 8
CPU ranks at dp = 2 x pp = 2 x tp = 2 (JAX's reference case and JAX's
full train step with a dp-sharded batch and ZeRO-1, against JAX's
driver) and a world of 2 at pp = 2 (a save and resume bit for bit, in
JAX's pipeline layout; ``finetune.main --pp 2`` against one process)."""

import glob
import os
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
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch import safetensors_io

import test_torch_pipeline as tpl
import test_torch_pipeline_reference as tref
import torch_world

torch.set_num_threads(1)

REF8 = (2, 2, 2, 1, 4)
# JAX's test_full_train_step_dp_sharded_batch_argument: dp2 x pp2 x tp2
TRAIN_MODEL = dict(hidden_size=64, num_layers=4, num_attention_heads=8,
                   num_kv_heads=8, ffn_hidden_size=128, vocab_size=256,
                   seq_length=32, make_vocab_size_divisible_by=16)
TRAIN = dict(seq_length=32, micro_batch_size=2, global_batch_size=16,
             train_iters=2, log_interval=1)
TRAIN_PAR = dict(data_parallel=2, pipeline_parallel=2, tensor_parallel=2,
                 num_microbatches=4, use_distributed_optimizer=True)
OPT = dict(lr=1e-3, clip_grad=1.0)
# the save and resume at pp = 2
RESUME_MODEL = tpl._model_kw(4)
RESUME_PAR = dict(pipeline_parallel=2, num_microbatches=2)
RESUME_TRAIN = dict(seq_length=32, micro_batch_size=2, global_batch_size=4,
                    train_iters=4, log_interval=1)
FINETUNE = ["--model", "tiny", "--mock_data", "--device", "cpu",
            "--seq_length", "32", "--params_dtype", "float32",
            "--micro_batch_size", "2", "--global_batch_size", "4",
            "--train_iters", "3", "--log_interval", "1", "--eval_iters", "1",
            "--eval_interval", "3", "--recompute", "none",
            "--attention_impl", "dot"]


def _batches(shape, vocab, n, seed):
    g = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        toks = g.integers(0, vocab, shape)
        out[str(i)] = {"tokens": toks.astype(np.int64),
                       "labels": np.roll(toks, -1, -1).astype(np.int64),
                       "loss_mask": np.ones(shape, np.float32)}
    return out


def _provider(batches):
    def provider(consumed, gbs):
        i = consumed // gbs
        while True:
            yield batches[str(i)]
            i += 1
    return provider


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    kw, batch = tpl.case_inputs(REF8)
    dp, pp, tp, vpp, M = REF8
    jobs = [("pipeline_case", {"params": tpl._jparams(kw), "batch": batch},
             tpl._meta(kw, dp, pp, tp, vpp, M)),
            ("pretrain_case",
             {"params": jax.tree.map(np.asarray, jm.init_params(
                 jax.random.key(0), jtiny(**TRAIN_MODEL), tp=2)),
              "batches": _batches((4, 4, 32), 256, 2, 0)},
             dict(model=("tiny_config", TRAIN_MODEL), parallel=TRAIN_PAR,
                  optimizer=OPT, train=TRAIN))]
    tmp = tmp_path_factory.mktemp("pipe8")
    out.update(zip(["ref8", "train8"], torch_world.run_world(8, tmp, jobs)))

    tmp = tmp_path_factory.mktemp("pipe2train")
    root = str(tmp / "ckpt")
    params = tpl._jparams(RESUME_MODEL, 4)
    batches = _batches((2, 2, 32), 256, 4, 9)

    def meta(**train):
        return dict(model=("tiny_config", RESUME_MODEL),
                    parallel=RESUME_PAR, optimizer=OPT,
                    train=dict(RESUME_TRAIN, **train))

    jobs = [("pretrain_case", {"params": params, "batches": batches},
             meta()),
            ("pretrain_case", {"params": params, "batches": batches},
             meta(exit_interval=2, save=root)),
            ("pretrain_case", {"batches": batches}, meta(load=root)),
            ("entry_case", {}, dict(entry="finetune",
                                    argv=FINETUNE + ["--pp", "2"]))]
    out.update(zip(["straight", "saved", "resumed", "finetune"],
                   torch_world.run_world(2, tmp, jobs)))
    out["root"] = root
    return out


def test_pipeline_matches_reference(worlds):
    """JAX's dp2 x pp2 x tp2 case (M = 4) in a world of 8: the loss and
    grads equal JAX's unpipelined and pipelined ones."""
    tref.check_case(worlds["ref8"], REF8, "dp2_pp2_tp2_m4")


def test_full_train_step_matches_jax_driver(worlds, capsys):
    """Two steps of the port's ``pretrain`` at dp2 x pp2 x tp2 with ZeRO-1
    (a dp-sharded batch, four microbatches) log JAX's driver's losses at
    the same degrees."""
    jc = JRun(model=jtiny(**TRAIN_MODEL), parallel=JPar(**TRAIN_PAR),
              optimizer=JOpt(**OPT), train=JTrain(**TRAIN)).validate()
    params = jm.init_params(jax.random.key(0), jc.model, tp=2)
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _batches((4, 4, 32), 256, 2, 0).items()}
    capsys.readouterr()
    jdriver.pretrain(jc, params=params, batch_provider=_provider(batches))
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|",
                                         capsys.readouterr().out)]
    got = worlds["train8"]["losses"]
    assert len(want) == len(got) == 2
    np.testing.assert_allclose(got, want, **tpl.LOSS_TOL)


def test_save_and_resume_at_pp2_bit_for_bit(worlds):
    """Two steps at pp = 2 that exit and save, resumed at pp = 2: the four
    losses are the uninterrupted run's bit for bit, the resumed params
    and moments too, and the checkpoint holds the layer leaves in JAX's
    pipeline layout ``[vpp, pp, lpc, ...]``."""
    straight, saved, resumed = (worlds[k] for k in
                                ("straight", "saved", "resumed"))
    np.testing.assert_array_equal(
        np.r_[saved["losses"], resumed["losses"]], straight["losses"])
    for name in ("params", "mu", "nu"):
        for k, x in torch_world.flatten(straight[name]).items():
            np.testing.assert_array_equal(
                torch_world.flatten(resumed[name])[k], x,
                err_msg=f"resumed {name} differs at {k}")
    shapes = {}
    for f in glob.glob(os.path.join(worlds["root"], "iter_*", "state",
                                    "*.safetensors")):
        header, _ = safetensors_io.read_header(f)
        shapes.update({k: v["shape"] for k, v in header.items()
                       if k != "__metadata__"})
    h = RESUME_MODEL.get("hidden_size", 64)
    assert shapes["params.layers.attn.wq"][:3] == [1, 2, 2]
    assert shapes["params.layers.input_norm.scale"] == [1, 2, 2, h]


def test_finetune_main_pp2_matches_one_process(worlds, capsys):
    """``finetune.main --pp 2 --mock_data`` in a world of 2 logs the
    losses of the same finetune in one process (and its validation
    loss through the pipelined eval step)."""
    assert tfinetune.main(FINETUNE) == 0
    out = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]
    valid = [float(x) for x in re.findall(
        r"validation loss at .*? lm_loss: ([0-9.E+-]+) \|", out)]
    got = worlds["finetune"]
    assert len(want) == 3 and len(valid) >= 1
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["valid"], valid, rtol=1e-5, atol=1e-5)
