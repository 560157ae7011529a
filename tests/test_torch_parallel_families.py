"""The encoder families and the entries under parallelism, in a world of two
CPU ranks, against the JAX package.

One world (``tests/torch_world.py``) runs every case of the module:

- BERT's loss and grads at tp = 2 through ``bert_param_specs``, and T5's
  logits, loss and grads through ``t5_param_specs``, against JAX
  unsharded (``tests/test_torch_encdec.py``'s batches and tolerances);
- the ICT loss at dp = 2 through ``biencoder_param_specs``: each rank's
  queries score the contexts of the whole global batch, JAX's in-batch
  softmax;
- ``pretrain_bert`` and ``pretrain_t5`` with ``--tensor_parallel 2`` and
  ``--use_distributed_optimizer``, and ``pretrain_ict`` with
  ``--data_parallel 2`` (``pretrain_custom(param_specs=)``);
- ``finetune --tp 2 --sequence_parallel``, whose losses equal the same
  run at tp = 1 in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModelConfig
from megatron_llm_tpu.models import biencoder as jbi
from megatron_llm_tpu.models import encdec as jencdec
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.data import indexed_dataset as tidx

import test_torch_biencoder as tbi
import test_torch_encdec as tenc
import torch_world

torch.set_num_threads(1)

TP = 2
BERT = dict(tenc.BASE, tokentype_size=2)
T5 = dict(tenc.BASE, num_decoder_layers=2)
FINETUNE = ["--model", "tiny", "--mock_data", "--train_iters", "3",
            "--device", "cpu", "--log_interval", "1", "--seq_length", "32",
            "--micro_batch_size", "2", "--global_batch_size", "4",
            "--eval_iters", "1", "--eval_interval", "2",
            "--params_dtype", "float32"]


def _i64(batch):
    return {k: v.astype(np.int64) if v.dtype.kind == "i" else v
            for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _corpus(path):
    """The entry tests' corpus: 30 documents of 3-6 sentences."""
    rng = np.random.default_rng(0)
    b = tidx.MMapIndexedDatasetBuilder(str(path), dtype=np.int32)
    for _ in range(30):
        for _ in range(int(rng.integers(3, 7))):
            b.add_item(rng.integers(1, 80, int(rng.integers(6, 14))))
        b.end_document()
    b.finalize()
    return str(path)


def _entry_argv(corpus, *flags):
    return ["--data_path", corpus, "--vocab_size", "96", "--hidden_size",
            "32", "--num_layers", "2", "--num_attention_heads", "4",
            "--train_iters", "2", "--log_interval", "1", *flags]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    corpus = _corpus(tmp / "sentences")
    jobs = [
        ("grads_case",
         {"params": _np(jencdec.init_bert_params(
             jax.random.key(0), JModelConfig(**BERT), tp=TP)),
          "batch": _i64(tenc.bert_batch(lens=(32, 20, 9, 27)) | {
              "is_random": np.asarray([0, 1, 1, 0], np.int64)})},
         dict(model=("ModelConfig", BERT), kind="bert",
              parallel=dict(tensor_parallel=TP),
              train=dict(seq_length=tenc.SEQ))),
        ("grads_case",
         {"params": _np(jencdec.init_t5_params(
             jax.random.key(0), JModelConfig(**T5), tp=TP)),
          "batch": _i64(tenc.t5_batch())},
         dict(model=("ModelConfig", T5), kind="t5", logits=True,
              parallel=dict(tensor_parallel=TP),
              train=dict(seq_length=tenc.SEQ))),
        ("grads_case",
         {"params": _np(jbi.init_biencoder_params(
             jax.random.key(0), JModelConfig(**tbi.KW))),
          "batch": _i64(tbi._batch())},
         dict(model=("ModelConfig", tbi.KW), kind="ict",
              parallel=dict(data_parallel=TP),
              train=dict(micro_batch_size=2, global_batch_size=4,
                         seq_length=48))),
        ("entry_case", {}, dict(entry="pretrain_bert", argv=_entry_argv(
            corpus, "--seq_length", "48", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--tensor_parallel", "2",
            "--use_distributed_optimizer"))),
        ("entry_case", {}, dict(entry="pretrain_t5", argv=_entry_argv(
            corpus, "--encoder_seq_length", "48", "--decoder_seq_length",
            "24", "--micro_batch_size", "2", "--global_batch_size", "4",
            "--tensor_parallel", "2"))),
        ("entry_case", {}, dict(entry="pretrain_ict", argv=_entry_argv(
            corpus, "--query_seq_length", "16", "--block_seq_length", "48",
            "--projection_dim", "16", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--data_parallel", "2",
            "--use_distributed_optimizer"))),
        ("entry_case", {}, dict(entry="finetune", argv=FINETUNE + [
            "--tp", "2", "--sequence_parallel"])),
    ]
    names = ["bert", "t5", "ict", "pretrain_bert", "pretrain_t5",
             "pretrain_ict", "finetune"]
    return dict(zip(names, torch_world.run_world(TP, tmp, jobs)))


def _jax_loss_grads(loss_fn, cfg_kw, params, batch, logits_fn=None):
    cfg = JModelConfig(**cfg_kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(cfg, p, jb)))(params)
    logits = None if logits_fn is None else logits_fn(cfg, params, jb)
    return float(loss), _np(grads), logits


def _check(out, loss, grads, what):
    np.testing.assert_allclose(float(out["loss"]), loss, **tenc.LOSS_TOL)
    want, got = torch_world.flatten(grads), torch_world.flatten(out["grads"])
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **tenc.GRAD_TOL,
                                   err_msg=f"{what}: grad {k}")


def test_bert_tp2_matches_jax(world):
    params = jencdec.init_bert_params(jax.random.key(0),
                                      JModelConfig(**BERT), tp=TP)
    batch = _i64(tenc.bert_batch(lens=(32, 20, 9, 27)) | {
        "is_random": np.asarray([0, 1, 1, 0], np.int64)})
    loss, grads, _ = _jax_loss_grads(jencdec.bert_loss, BERT, params, batch)
    _check(world["bert"], loss, grads, "BERT tp=2")


def test_t5_tp2_matches_jax(world):
    params = jencdec.init_t5_params(jax.random.key(0), JModelConfig(**T5),
                                    tp=TP)
    batch = _i64(tenc.t5_batch())
    loss, grads, logits = _jax_loss_grads(
        jencdec.t5_loss, T5, params, batch,
        lambda c, p, b: jencdec.t5_forward(
            c, p, b["enc_tokens"], b["dec_tokens"], b["enc_pad_mask"],
            b["dec_pad_mask"]))
    np.testing.assert_allclose(world["t5"]["logits"], np.asarray(logits),
                               **tenc.LOGIT_TOL)
    _check(world["t5"], loss, grads, "T5 tp=2")


def test_ict_dp2_scores_the_global_batch(world):
    params = jbi.init_biencoder_params(jax.random.key(0),
                                       JModelConfig(**tbi.KW))
    loss, grads, _ = _jax_loss_grads(jbi.retrieval_loss, tbi.KW, params,
                                     _i64(tbi._batch()))
    _check(world["ict"], loss, grads, "ICT dp=2")


@pytest.mark.parametrize("entry", ["pretrain_bert", "pretrain_t5",
                                   "pretrain_ict"])
def test_entries_train_under_parallelism(world, entry):
    """The entries take ``--tensor_parallel 2`` (BERT, T5) and
    ``--data_parallel 2`` (ICT), with ZeRO-1 where asked, in a world of two
    ranks: two iterations, each logging a finite loss once."""
    out = world[entry]
    assert int(out["iters"]) == 2
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))


def test_finetune_tp2_sequence_parallel_equals_tp1(world, capsys):
    """``finetune --tp 2 --sequence_parallel`` in a world of two logs the
    one-process run's losses and validation losses (fp32; the same seed
    draws the same whole weights; the vocabulary pads alike; evaluation
    gathers the vocab-sharded logits)."""
    import re

    capsys.readouterr()
    assert tfinetune.main(FINETUNE) == 0
    out = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]
    valid = [float(x) for x in re.findall(
        r"validation loss at .*? lm_loss: ([0-9.E+-]+) \|", out)]
    got = world["finetune"]
    assert len(want) == len(got["losses"]) == 3 and len(valid) >= 1
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    np.testing.assert_allclose(got["valid"], valid, rtol=1e-5)
