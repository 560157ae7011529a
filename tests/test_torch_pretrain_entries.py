"""``training/driver.py:pretrain_custom`` and the ``pretrain_bert``,
``pretrain_t5`` and ``pretrain_ict`` entries of the port, on the CPU.

- ``pretrain_custom``'s first losses against JAX ``pretrain_custom`` on the
  same corpus, weights and sample order at dropout 0;
- each entry's ``main`` for 2 iterations with ``--vocab_size`` (the JAX
  entry's flags, dropout on where the entry sets it), a checkpoint, and a
  resume that reproduces the straight run bit for bit;
- the parallel flags in one process (``--tensor_parallel``,
  ``--pipeline_parallel`` ask for a launcher; ``--pipeline_split_rank``
  without a pipeline is JAX's refusal), ``param_specs`` and
  ``pipeline_loss_fn``'s checks, and no card without ``device="cpu"``.
"""

import re

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModel
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.data import bert_dataset as jbert
from megatron_llm_tpu.data import indexed_dataset as jidx
from megatron_llm_tpu.data import t5_dataset as jt5
from megatron_llm_tpu.models import encdec as jencdec
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch import pretrain_bert, pretrain_ict, pretrain_t5
from megatron_llm_tpu_torch.config import ModelConfig as TModel
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.data import bert_dataset as tbert
from megatron_llm_tpu_torch.data import indexed_dataset as tidx
from megatron_llm_tpu_torch.data import t5_dataset as tt5
from megatron_llm_tpu_torch.models import encdec as tencdec
from megatron_llm_tpu_torch.training import driver as tdriver
from megatron_llm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

VOCAB = 96
# fp32 on both sides, JAX's losses read from its log (%.6E: 5e-7
# relative); the first step's loss differs by reassociation alone and
# AdamW (lr 1e-3) carries it into the next steps: on this suite's host
# the gaps were 3e-9 to 1.3e-7 relative
LOSS_RTOL = 2e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """30 documents of 3-6 sentences of 6-13 tokens (the JAX entry tests'
    corpus), written by the port."""
    path = tmp_path_factory.mktemp("corpus") / "sentences"
    rng = np.random.default_rng(0)
    b = tidx.MMapIndexedDatasetBuilder(str(path), dtype=np.int32)
    for _ in range(30):
        for _ in range(int(rng.integers(3, 7))):
            b.add_item(rng.integers(1, 80, int(rng.integers(6, 14))))
        b.end_document()
    b.finalize()
    return str(path)


MODEL = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
             num_attention_heads=4, num_kv_heads=4, ffn_hidden_size=128,
             max_position_embeddings=48, norm_type="layernorm",
             activation="gelu", position_embedding_type="absolute",
             use_bias=True, tie_embed_logits=True, params_dtype="float32",
             recompute="none", make_vocab_size_divisible_by=8, seq_length=48)
OPT = dict(lr=1e-3, clip_grad=1.0, lr_warmup_iters=1)
TRAIN = dict(train_iters=3, micro_batch_size=2, global_batch_size=4,
             seq_length=48, log_interval=1, seed=5)


def _log_losses(text):
    return [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", text)]


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_pretrain_custom_losses_match_jax(corpus, family, capsys):
    extra = (dict(tokentype_size=2) if family == "bert"
             else dict(num_decoder_layers=2))
    jc = JRun(model=JModel(**MODEL, **extra), parallel=JPar(),
              optimizer=JOpt(**OPT), train=JTrain(**TRAIN)).validate()
    tc = TRun(model=TModel(**MODEL, **extra), optimizer=TOpt(**OPT),
              train=TTrain(**TRAIN)).validate()
    if family == "bert":
        jds = jbert.BertDataset(
            jidx.MMapIndexedDataset(corpus), 48, VOCAB,
            jbert.BertSpecialTokens(cls=92, sep=93, mask=94, pad=0), seed=5)
        tds = tbert.BertDataset(
            tidx.MMapIndexedDataset(corpus), 48, VOCAB,
            tbert.BertSpecialTokens(cls=92, sep=93, mask=94, pad=0), seed=5)
        jp = jencdec.init_bert_params(jax.random.key(0), jc.model)
        j_loss = lambda c, p, mb, r, d: jencdec.bert_loss(  # noqa: E731
            c.model, p, mb, r, d)
        t_loss = pretrain_bert.bert_loss_fn
    else:
        jds = jt5.T5Dataset(jidx.MMapIndexedDataset(corpus), 48, 24, VOCAB,
                            jt5.T5SpecialTokens(bos=0, eos=1, pad=0), seed=5)
        tds = tt5.T5Dataset(tidx.MMapIndexedDataset(corpus), 48, 24, VOCAB,
                            tt5.T5SpecialTokens(bos=0, eos=1, pad=0), seed=5)
        jp = jencdec.init_t5_params(jax.random.key(0), jc.model)
        j_loss = lambda c, p, mb, r, d: jencdec.t5_loss(  # noqa: E731
            c.model, p, mb, r, d)
        t_loss = pretrain_t5.t5_loss_fn
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jdriver.pretrain_custom(jc, jds, jp, j_loss)
    want = _log_losses(capsys.readouterr().out)
    got = []
    state = tdriver.pretrain_custom(
        tc, tds, tp, t_loss, device="cpu",
        on_step=lambda it, m, s: got.append(float(m["loss"])))
    logged = _log_losses(capsys.readouterr().out)
    assert int(state.iteration) == 3 and len(want) == len(got) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(logged, got, rtol=1e-6)   # %.6E


def _bert_argv(corpus, iters, save, save_interval=100):
    return ["--data_path", corpus, "--vocab_size", str(VOCAB),
            "--hidden_size", "32", "--num_layers", "2",
            "--num_attention_heads", "4", "--seq_length", "48",
            "--micro_batch_size", "2", "--global_batch_size", "4",
            "--train_iters", str(iters), "--log_interval", "1",
            "--save", str(save), "--save_interval", str(save_interval)]


# each entry's flags past the common ones (tiny widths, --vocab_size)
ENTRY_ARGS = {
    "bert": (pretrain_bert, ["--seq_length", "48", "--micro_batch_size",
                             "2", "--global_batch_size", "4"]),
    "t5": (pretrain_t5, ["--encoder_seq_length", "48",
                         "--decoder_seq_length", "24", "--micro_batch_size",
                         "2", "--global_batch_size", "4"]),
    "ict": (pretrain_ict, ["--query_seq_length", "16", "--block_seq_length",
                           "48", "--projection_dim", "16",
                           "--shared_query_context_model",
                           "--micro_batch_size", "4", "--global_batch_size",
                           "4"]),
}


@pytest.mark.parametrize("family", sorted(ENTRY_ARGS))
def test_entry_main_trains_saves_and_resumes(corpus, tmp_path, capsys,
                                             family):
    """3 iterations with ``--vocab_size`` and a checkpoint at 2 and at the
    end; a resume from the one at 2 reproduces iteration 3 bit for bit
    (BERT and ICT with the entries' dropout 0.1: the masks are keyed by
    the iteration, the sample order by the consumed samples, the schedule
    by the optimizer's step)."""
    import shutil

    from megatron_llm_tpu_torch import checkpointing

    entry, extra = ENTRY_ARGS[family]
    root = tmp_path / family
    argv = ["--data_path", corpus, "--vocab_size", str(VOCAB),
            "--hidden_size", "32", "--num_layers", "2",
            "--num_attention_heads", "4", "--train_iters", "3",
            "--log_interval", "1", "--save", str(root), "--save_interval",
            "2", *extra]
    straight = entry.main(argv, device="cpu")
    assert int(straight.iteration) == 3
    assert (root / "iter_0000002").exists()
    shutil.rmtree(root / "iter_0000003")
    checkpointing.write_tracker(str(root), 2)
    capsys.readouterr()
    resumed = entry.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "loaded checkpoint" in out and "consumed_samples=8" in out
    assert len(_log_losses(out)) == 1          # one step trained
    assert int(resumed.iteration) == 3
    for a, b in zip(tree_leaves(resumed.params),
                    tree_leaves(straight.params)):
        assert torch.equal(a, b)
    if family == "t5":
        assert straight.params["cross"]["wq"].shape == (2, 32, 32)
    if family == "ict":
        assert "context" not in straight.params          # shared towers
        assert set(straight.params["projection"]) == {"q"}


def test_entries_mirror_the_jax_configs(corpus):
    """The model configs are the JAX entries', field for field: dot
    attention and XLA norms, so the entries launch no kernel."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    jbert_entry = importlib.import_module("pretrain_bert")
    jt5_entry = importlib.import_module("pretrain_t5")
    argv = _bert_argv(corpus, 2, "x")
    a = jbert_entry.bert_runtime_config(jbert_entry.get_args(argv), VOCAB)
    b = pretrain_bert.bert_runtime_config(pretrain_bert.get_args(argv),
                                          VOCAB)
    for f in ("attention_impl", "norm_impl", "hidden_dropout",
              "attention_dropout", "tokentype_size", "max_position_embeddings",
              "ffn_hidden_size", "recompute"):
        assert getattr(a.model, f) == getattr(b.model, f), f
    assert b.model.attention_impl == "dot" and b.model.norm_impl == "xla"
    t_argv = ["--data_path", corpus, "--vocab_size", "96"]
    a = jt5_entry.t5_runtime_config(jt5_entry.get_args(t_argv))
    b = pretrain_t5.t5_runtime_config(pretrain_t5.get_args(t_argv))
    for f in ("attention_impl", "norm_impl", "attention_dropout",
              "num_decoder_layers", "max_position_embeddings"):
        assert getattr(a.model, f) == getattr(b.model, f), f


@pytest.mark.parametrize("entry,flags,item", [
    (pretrain_bert, ["--tensor_parallel", "2"], "item 9"),
    (pretrain_bert, ["--use_distributed_optimizer"], "item 9"),
    (pretrain_bert, ["--pipeline_parallel", "2"], "item 10"),
    (pretrain_t5, ["--tensor_parallel", "2"], "item 9"),
    (pretrain_t5, ["--pipeline_parallel", "2"], "item 10"),
    (pretrain_t5, ["--pipeline_split_rank", "1"], "item 10"),
    (pretrain_ict, ["--tensor_parallel", "2"], "item 9"),
    (pretrain_ict, ["--use_distributed_optimizer"], "item 9"),
])
def test_entries_refuse_unported_parallelism(corpus, entry, flags, item):
    """Item 9's and item 10's flags are ported.  ``--use_distributed_
    optimizer`` at dp = 1 trains (ZeRO-1 over one rank is the replicated
    optimizer, as in JAX); ``--tensor_parallel 2`` and
    ``--pipeline_parallel 2`` in one process ask for a launcher with two
    ranks (``tests/test_torch_parallel_families.py`` and
    ``tests/test_torch_pipeline_encdec.py`` run the entries in a world of
    two); ``--pipeline_split_rank`` without a pipeline is refused as
    JAX's ``ParallelConfig`` refuses it (the split must lie in ``(0,
    pp)``)."""
    argv = ["--data_path", corpus, "--vocab_size", "96", *flags]
    if "--pipeline_split_rank" in flags:
        with pytest.raises(ValueError, match="pipeline_split_rank"):
            entry.main(argv, device="cpu")
    elif "--tensor_parallel" in flags or "--pipeline_parallel" in flags:
        with pytest.raises(ValueError, match="torchrun"):
            entry.main(argv, device="cpu")
    else:
        extra = next(e for m, e in ENTRY_ARGS.values() if m is entry)
        state = entry.main(argv + ["--train_iters", "1", "--hidden_size",
                                   "32", "--num_layers", "1",
                                   "--num_attention_heads", "2", *extra],
                           device="cpu")
        assert int(state.iteration) == 1


def test_pretrain_custom_refuses_specs_and_pipelines(corpus):
    """``param_specs`` is ported (a degree-1 layout trains as before);
    ``pipeline_loss_fn`` is ported, with JAX's checks
    (``training/driver.py:935-943``): it needs pp > 1 and the staged
    specs, and refuses ``eval_loss_fn``; ep > 1 has no experts to split in
    these families (JAX ``models/encdec.py:83, :215``)."""
    tc = TRun(model=TModel(**MODEL, tokentype_size=2),
              train=TTrain(**dict(TRAIN, train_iters=0))).validate()
    params = tencdec.init_bert_params(tc.model, device="cpu")
    state = tdriver.pretrain_custom(
        tc, [], params, None, device="cpu",
        param_specs=tencdec.bert_param_specs(tc.model, tc.parallel))
    assert state.iteration == 0
    with pytest.raises(ValueError, match="pipeline_parallel > 1"):
        tdriver.pretrain_custom(tc, [], params, None,
                                pipeline_loss_fn=lambda *a: 0, device="cpu")
    from megatron_llm_tpu_torch.config import ParallelConfig as TPar
    from megatron_llm_tpu_torch.parallel import pipeline_encdec as tpe

    pc = TRun(model=tc.model, parallel=TPar(pipeline_parallel=2,
                                            num_microbatches=2),
              train=TTrain(**dict(TRAIN, train_iters=0))).validate()
    with pytest.raises(ValueError, match="eval_loss_fn"):
        tdriver.pretrain_custom(
            pc, [], params, None, eval_loss_fn=lambda *a: 0,
            param_specs=tpe.bert_pipeline_param_specs(pc.model, pc.parallel),
            pipeline_loss_fn=tpe.bert_pipeline_loss, device="cpu")
    ec = TRun(model=TModel(**dict(MODEL, use_bias=False), tokentype_size=2,
                           num_experts=2),
              parallel=TPar(expert_parallel=2),
              train=TTrain(**dict(TRAIN, train_iters=0))).validate()
    with pytest.raises(NotImplementedError, match="encoder stacks"):
        tdriver.pretrain_custom(ec, [], params, None, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card")
def test_entries_need_the_card_unless_asked_for_the_cpu(corpus):
    """Without ``device="cpu"`` the entries and ``pretrain_custom`` go to
    the card, and on a host without one they fail."""
    with pytest.raises((RuntimeError, AssertionError)):
        pretrain_bert.main(_bert_argv(corpus, 1, "unused"))
    tc = TRun(model=TModel(**MODEL, tokentype_size=2),
              train=TTrain(**TRAIN)).validate()
    params = tencdec.init_bert_params(tc.model, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        tdriver.pretrain_custom(tc, [], params, pretrain_bert.bert_loss_fn)
