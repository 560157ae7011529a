"""The split-rank encoder-decoder (T5) and encoder (BERT) pipelines
(``parallel/pipeline_encdec.py``) in gloo worlds of 2, 4 and 8 CPU ranks
against the JAX package's (mirror of
``tests/parallel/test_pipeline_encdec.py``).

JAX's pipelined loss and grads (``t5_pipeline_loss`` /
``bert_pipeline_loss`` on its 8-device CPU mesh) are computed in the pytest
process; the ranks take the same weights (JAX's init, unpipelined layout)
and batch, stage them, run the port's pipeline and reduce as the step
does.  JAX's cases and limits: loss rtol = atol = 2e-5, grads 1e-4 (the
staged ``[pp, lpc, ...]`` grads leaf for leaf).  Also: the encoder
stages' cross-attention grads exactly 0, the forward-only pass (the
pipelined evaluation) equal to the loss, the layouts' round trips beside
JAX's, the split-rank validation, and ``pretrain_t5`` / ``pretrain_bert``
at pp = 2 with a save and a resume that is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from megatron_llm_tpu.config import ModelConfig as JModel
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.models import encdec as jencdec
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu.parallel import pipeline_encdec as jpe
from megatron_llm_tpu_torch.config import ModelConfig as TModel
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.parallel import pipeline_encdec as tpe

import test_torch_parallel_families as fam
import torch_world

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# JAX's cases: (dp, pp, tp, split, M, s_enc, s_dec, W) and (dp, pp, tp, M, W)
T5_CASES = [(1, 2, 1, 1, 3, 32, 32, 0),    # minimal split
            (1, 4, 1, 2, 4, 32, 16, 0),    # uneven lengths
            (2, 2, 2, 1, 4, 32, 32, 0),    # dp x pp x tp
            (1, 4, 1, 2, 6, 32, 32, 3),    # the remat window
            (1, 4, 1, 1, 4, 16, 32, 0)]    # asymmetric split
BERT_CASES = [(1, 2, 1, 3, 0), (1, 4, 1, 4, 0), (2, 2, 2, 4, 0),
              (1, 4, 1, 6, 3)]


def _t5_kw(num_layers=4, num_decoder_layers=4, **over):
    base = dict(
        vocab_size=96, hidden_size=48, num_layers=num_layers,
        num_decoder_layers=num_decoder_layers, num_attention_heads=4,
        num_kv_heads=4, ffn_hidden_size=96, max_position_embeddings=64,
        norm_type="layernorm", activation="gelu",
        position_embedding_type="absolute", use_bias=True,
        tie_embed_logits=True, tokentype_size=0,
        params_dtype="float32", attention_impl="dot", recompute="none",
        make_vocab_size_divisible_by=8, seq_length=32)
    base.update(over)
    return base


def _bert_kw(num_layers=4, **over):
    return _t5_kw(num_layers=num_layers, num_decoder_layers=None,
                  tokentype_size=2, **over)


def _t5_batch(M, mb, s_enc, s_dec, seed=0):
    g = np.random.default_rng(seed)
    enc_pad = np.ones((M, mb, s_enc), np.float32)
    dec_pad = np.ones((M, mb, s_dec), np.float32)
    enc_pad[:, :, s_enc - 3:] = 0.0
    dec_pad[:, 0, s_dec - 2:] = 0.0
    return {"enc_tokens": g.integers(0, 96, (M, mb, s_enc)),
            "dec_tokens": g.integers(0, 96, (M, mb, s_dec)),
            "labels": g.integers(0, 96, (M, mb, s_dec)),
            "loss_mask": dec_pad, "enc_pad_mask": enc_pad,
            "dec_pad_mask": dec_pad}


def _bert_batch(M, mb, s, seed=0):
    g = np.random.default_rng(seed)
    pad = np.ones((M, mb, s), np.float32)
    pad[:, :, s - 3:] = 0.0
    return {"tokens": g.integers(0, 96, (M, mb, s)), "pad_mask": pad,
            "labels": g.integers(0, 96, (M, mb, s)),
            "loss_mask": (pad * (g.random((M, mb, s)) < 0.3)).astype(
                np.float32),
            "tokentype_ids": g.integers(0, 2, (M, mb, s)),
            "is_random": g.integers(0, 2, (M, mb))}


def _t5_case(case):
    dp, pp, tp, split, M, s_enc, s_dec, W = case
    kw = _t5_kw(num_layers=split * 2, num_decoder_layers=(pp - split) * 2,
                seq_length=max(s_enc, s_dec),
                max_position_embeddings=max(s_enc, s_dec))
    par = dict(data_parallel=dp, pipeline_parallel=pp, tensor_parallel=tp,
               pipeline_split_rank=split, num_microbatches=M,
               pipeline_remat_window=W)
    return kw, par, _t5_batch(M, 2, s_enc, s_dec)


def _bert_case(case):
    dp, pp, tp, M, W = case
    kw = _bert_kw(num_layers=pp * 2)
    par = dict(data_parallel=dp, pipeline_parallel=pp, tensor_parallel=tp,
               num_microbatches=M, pipeline_remat_window=W)
    return kw, par, _bert_batch(M, 2, 32)


def _init(kind, kw):
    init = jencdec.init_t5_params if kind == "t5" else \
        jencdec.init_bert_params
    return init(jax.random.key(0), JModel(**kw).validate())


def _jax_pipeline(kind, kw, par, batch):
    """JAX's pipelined loss and staged grads on its CPU mesh."""
    cfg = JModel(**kw).validate()
    parallel = JPar(**par).validate()
    mesh = jmesh.build_mesh(parallel)
    to, specs_of, loss_of = {
        "t5": (jpe.t5_to_pipeline_params, jpe.t5_pipeline_param_specs,
               jpe.t5_pipeline_loss),
        "bert": (jpe.bert_to_pipeline_params, jpe.bert_pipeline_param_specs,
                 jpe.bert_pipeline_loss)}[kind]
    staged = to(_init(kind, kw), parallel)
    staged = jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), staged,
        specs_of(cfg, parallel), is_leaf=lambda v: isinstance(v, P))
    runtime = JRun(model=cfg, parallel=parallel, optimizer=JOpt(),
                   train=JTrain(seq_length=cfg.seq_length))
    batch = {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32
                            else jnp.int32) for k, v in batch.items()}
    with jmesh.use_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_of(runtime, p, batch, mesh=mesh)))(staged)
    return float(loss), jax.tree.map(np.asarray, grads)


def _job(kind, case):
    kw, par, batch = (_t5_case if kind == "t5" else _bert_case)(case)
    world = par["data_parallel"] * par["pipeline_parallel"] * \
        par["tensor_parallel"]
    dp, M = par["data_parallel"], par["num_microbatches"]
    meta = dict(model=("ModelConfig", kw), kind=kind, parallel=par,
                train=dict(seq_length=kw["seq_length"], micro_batch_size=2
                           // dp, global_batch_size=2 * M))
    return world, ("encdec_pipeline_case",
                   {"params": fam._np(_init(kind, kw)),
                    "batch": fam._i64(batch)}, meta)


def _entry_argv(corpus, entry, root, *flags):
    extra = {"pretrain_t5": ["--encoder_seq_length", "48",
                             "--decoder_seq_length", "24"],
             "pretrain_bert": ["--seq_length", "48"]}[entry]
    return ["--data_path", corpus, "--vocab_size", "96", "--hidden_size",
            "32", "--num_layers", "2", "--num_attention_heads", "4",
            "--micro_batch_size", "2", "--global_batch_size", "4",
            "--train_iters", "3", "--log_interval", "1", "--save", root,
            "--save_interval", "2", *extra, *flags]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("encdec_pipe")
    corpus = fam._corpus(tmp / "sentences")
    by_world, names = {}, {}
    for kind, cases in (("t5", T5_CASES), ("bert", BERT_CASES)):
        for case in cases:
            world, job = _job(kind, case)
            by_world.setdefault(world, []).append(job)
            names.setdefault(world, []).append(f"{kind}{case}")
    for entry in ("pretrain_t5", "pretrain_bert"):
        by_world[2].append(("entry_resume_case", {}, dict(
            entry=entry, root=str(tmp / entry),
            argv=_entry_argv(corpus, entry, str(tmp / entry),
                             "--pipeline_parallel", "2"))))
        names[2].append(entry)
    out = {}
    for world, jobs in sorted(by_world.items()):
        out.update(zip(names[world], torch_world.run_world(
            world, tmp_path_factory.mktemp(f"w{world}"), jobs)))
    return out


def _check(kind, case, out):
    kw, par, batch = (_t5_case if kind == "t5" else _bert_case)(case)
    want_loss, want = _jax_pipeline(kind, kw, par, batch)
    np.testing.assert_allclose(float(out["loss"]), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(out["eval_loss"], want_loss, **LOSS_TOL)
    want, got = torch_world.flatten(want), torch_world.flatten(out["grads"])
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **GRAD_TOL,
                                   err_msg=f"{kind}{case}: grad {k}")


@pytest.mark.parametrize("case", T5_CASES, ids=str)
def test_t5_pipeline_matches_jax(worlds, case):
    """The port's split-rank pipeline, stage by stage in its own process,
    gives JAX's pipelined loss and staged grads in all five of JAX's
    cases: the minimal split, uneven lengths (the carry holds both),
    dp x pp x tp, the remat window (which changes nothing here) and the
    asymmetric split (1 encoder stage, 3 decoder stages)."""
    _check("t5", case, worlds[f"t5{case}"])


@pytest.mark.parametrize("case", BERT_CASES, ids=str)
def test_bert_pipeline_matches_jax(worlds, case):
    _check("bert", case, worlds[f"bert{case}"])


def test_t5_pipeline_dummy_cross_grads_are_zero(worlds):
    """The encoder stages' zero cross-attention weights get exactly zero
    grads (they never run there), while the decoder stages' train."""
    grads = worlds[f"t5{T5_CASES[0]}"]["grads"]["cross"]
    split = T5_CASES[0][3]
    for leaf in torch_world.flatten(grads).values():
        assert np.abs(leaf[:split]).max() == 0.0
    assert sum(np.abs(leaf[split:]).sum()
               for leaf in torch_world.flatten(grads).values()) > 0.0


@pytest.mark.parametrize("entry", ["pretrain_t5", "pretrain_bert"])
def test_entries_train_pipelined_and_resume_bit_for_bit(worlds, entry):
    """``pretrain_t5 --pipeline_parallel 2`` (split 1) and ``pretrain_bert
    --pipeline_parallel 2`` in a world of two: 3 iterations with a
    checkpoint of the staged layout at 2; a resume from it reproduces
    iteration 3's params bit for bit on every rank (BERT with the entry's
    dropout 0.1)."""
    out = worlds[entry]
    assert int(out["iters"]) == 3 and int(out["resumed_iters"]) == 3
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert int(out["resumed_steps"]) == 1
    assert int(out["differ"]) == 0


@pytest.mark.parametrize("kind", ["t5", "bert"])
def test_layouts_round_trip_as_jax(kind):
    """``*_to_pipeline_params`` equals JAX's leaf for leaf (zeros on the
    encoder stages' cross blocks), ``*_from_pipeline_params`` inverts it,
    and the staged specs equal JAX's."""
    case = T5_CASES[1] if kind == "t5" else BERT_CASES[1]
    kw, par, _ = (_t5_case if kind == "t5" else _bert_case)(case)
    jparams = _init(kind, kw)
    jpar, tpar = JPar(**par).validate(), TPar(**par).validate()
    j_to, j_specs = {"t5": (jpe.t5_to_pipeline_params,
                            jpe.t5_pipeline_param_specs),
                     "bert": (jpe.bert_to_pipeline_params,
                              jpe.bert_pipeline_param_specs)}[kind]
    t_to, t_from, t_specs = {
        "t5": (tpe.t5_to_pipeline_params, tpe.t5_from_pipeline_params,
               tpe.t5_pipeline_param_specs),
        "bert": (tpe.bert_to_pipeline_params, tpe.bert_from_pipeline_params,
                 tpe.bert_pipeline_param_specs)}[kind]
    tparams = params_from_jax(fam._np(jparams), device="cpu")
    staged = t_to(tparams, tpar)
    want = torch_world.flatten(fam._np(j_to(jparams, jpar)))
    got = torch_world.flatten(staged)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    back = torch_world.flatten(t_from(staged, tpar))
    assert sorted(back) == sorted(torch_world.flatten(tparams))
    for k, t in torch_world.flatten(tparams).items():
        assert torch.equal(back[k], t), k
    jspecs = torch_world.flatten(jax.tree.map(
        tuple, j_specs(JModel(**kw).validate(), jpar),
        is_leaf=lambda v: isinstance(v, P)))
    tspecs = torch_world.flatten(t_specs(TModel(**kw).validate(), tpar))
    assert jspecs == tspecs


def test_split_rank_validation():
    """JAX's checks: the split inside ``(0, pp)`` and equal
    layers-per-stage across it (JAX asserts, the port raises
    ``ValueError`` with the same messages)."""
    for split in (4, 0):
        with pytest.raises(ValueError, match="pipeline_split_rank"):
            TPar(pipeline_parallel=4, pipeline_split_rank=split).validate()
    kw = _t5_kw(num_layers=4, num_decoder_layers=2)
    par = TPar(pipeline_parallel=2, pipeline_split_rank=1,
               num_microbatches=2).validate()
    params = params_from_jax(fam._np(_init("t5", kw)), device="cpu")
    with pytest.raises(ValueError, match="layers-per-stage"):
        tpe.t5_to_pipeline_params(params, par)
    with pytest.raises(ValueError, match="decoder-only"):
        tpe._check_schedule(TPar(pipeline_parallel=2,
                                 virtual_pipeline_stages=2,
                                 num_microbatches=2).validate())
    with pytest.raises(ValueError, match="decoder-only"):
        tpe._check_schedule(TPar(pipeline_parallel=2, context_parallel=2,
                                 num_microbatches=2).validate())
