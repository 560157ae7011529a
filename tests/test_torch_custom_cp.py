"""Custom losses under context parallelism (the BERT, T5 and ICT losses,
``pretrain_custom``), and ``finetune`` with MoE under cp and under
sequence parallelism, in one gloo world of two CPU ranks, against the JAX
package.

JAX's ``pretrain_custom`` trains these families at cp = 2: their batch is
sharded over dp alone and only the ring's ``shard_map`` splits the
sequence, so its losses equal cp = 1's.  The port does the same
(``ring_attention.whole_sequence``): every cp rank runs the custom loss
on the whole batch, the ring takes its block of q, k and v.

- step 1's loss and grads through ``training/step.step_grads`` against
  JAX's unsharded ``value_and_grad`` (``tests/test_torch_encdec.py``'s and
  ``tests/test_torch_biencoder.py``'s limits);
- two steps of ``pretrain_custom`` against JAX's ``pretrain_custom`` at
  cp = 2 on its CPU mesh (``tests/test_torch_pretrain_entries.py``'s
  2e-5);
- ``finetune --num_experts 4 --cp 2`` (one routing group of the whole
  32 tokens, which straddles the cp blocks: both ranks route it whole)
  and ``--tp 2 --sequence_parallel`` against the same run in one
  process.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModel
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.models import biencoder as jbi
from megatron_llm_tpu.models import encdec as jencdec
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch import finetune as tfinetune

import test_torch_biencoder as tbi
import test_torch_encdec as tenc
import test_torch_parallel_families as fam
import torch_world

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
FAMILIES = {
    "bert": (dict(tenc.BASE, tokentype_size=2), jencdec.init_bert_params,
             jencdec.bert_loss, 32),
    "t5": (dict(tenc.BASE, num_decoder_layers=2), jencdec.init_t5_params,
           jencdec.t5_loss, 32),
    "ict": (tbi.KW, jbi.init_biencoder_params, jbi.retrieval_loss, 48),
}
TRAIN = dict(train_iters=2, micro_batch_size=2, global_batch_size=4,
             log_interval=1, seed=5)
OPT = dict(lr=1e-3, clip_grad=1.0)
MOE_FINETUNE = fam.FINETUNE + ["--num_experts", "4"]


def _batch(kind, b):
    if kind == "bert":
        lens = (32, 20, 9, 27, 31, 12, 25, 18)[:b]
        return fam._i64(tenc.bert_batch(lens=lens) | {
            "is_random": np.arange(b, dtype=np.int64) % 2})
    if kind == "t5":
        return fam._i64(tenc.t5_batch(
            enc_lens=(32, 24, 11, 30, 17, 28, 9, 21)[:b],
            dec_lens=(16, 9, 4, 12, 16, 7, 11, 5)[:b]))
    return fam._i64(tbi._batch(b=b))


def _params(kind):
    kw, init, _, _ = FAMILIES[kind]
    return init(jax.random.key(0), JModel(**kw))


def _meta(kind, **train):
    kw, _, _, seq = FAMILIES[kind]
    return dict(model=("ModelConfig", kw), kind=kind,
                parallel=dict(context_parallel=2),
                optimizer=OPT, train=dict(TRAIN, seq_length=seq, **train))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs, names = [], []
    for kind in FAMILIES:
        jobs.append(("custom_cp_case",
                     {"params": fam._np(_params(kind)),
                      "batch": _batch(kind, 4), "data": _batch(kind, 8)},
                     _meta(kind)))
        names.append(kind)
    for name, flags in (("moe_cp2", ["--cp", "2"]),
                        ("moe_tp2_sp", ["--tp", "2", "--sequence_parallel"])):
        jobs.append(("entry_case", {}, dict(entry="finetune",
                                            argv=MOE_FINETUNE + flags)))
        names.append(name)
    return dict(zip(names, torch_world.run_world(
        2, tmp_path_factory.mktemp("custom_cp"), jobs)))


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_custom_loss_step_under_cp_matches_jax(world, kind):
    """Step 1's loss and every grad of the family's loss at cp = 2 equal
    JAX's unsharded ones; they are whole on every cp rank, so the step
    sums nothing over cp."""
    kw, _, loss_fn, _ = FAMILIES[kind]
    loss, grads, _ = fam._jax_loss_grads(loss_fn, kw, _params(kind),
                                         _batch(kind, 4))
    fam._check(world[kind], loss, grads, f"{kind} cp=2")


class _Samples:
    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(next(iter(self.data.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.data.items()}


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_pretrain_custom_under_cp_matches_jax(world, kind, capsys):
    """Two steps of ``pretrain_custom`` at cp = 2 log JAX's
    ``pretrain_custom`` at cp = 2 (same weights, data and sample order)."""
    kw, _, loss_fn, seq = FAMILIES[kind]
    jc = JRun(model=JModel(**kw), parallel=JPar(context_parallel=2),
              optimizer=JOpt(**OPT),
              train=JTrain(**TRAIN, seq_length=seq)).validate()
    capsys.readouterr()
    jdriver.pretrain_custom(
        jc, _Samples(_batch(kind, 8)), _params(kind),
        lambda c, p, mb, r, d: loss_fn(c.model, p, mb, r, d))
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|",
                                         capsys.readouterr().out)]
    got = world[kind]["losses"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["moe_cp2", "moe_tp2_sp"])
def test_finetune_moe_layouts_equal_one_process(world, name, capsys):
    """``finetune --num_experts 4`` with ``--cp 2`` and with ``--tp 2
    --sequence_parallel`` in a world of two logs the one-process run's
    losses and validation losses (fp32)."""
    capsys.readouterr()
    assert tfinetune.main(MOE_FINETUNE) == 0
    out = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]
    valid = [float(x) for x in re.findall(
        r"validation loss at .*? lm_loss: ([0-9.E+-]+) \|", out)]
    got = world[name]
    assert len(want) == len(got["losses"]) == 3 and len(valid) >= 1
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    np.testing.assert_allclose(got["valid"], valid, rtol=1e-5)
