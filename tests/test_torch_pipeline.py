"""Pipeline parallelism: the port's 1F1B and interleaved schedules in gloo
worlds of 2 and 4 CPU ranks against the JAX package (mirror of
``tests/parallel/test_pipeline.py``, ``test_pipeline_eval.py`` and
``tests/models/test_moe.py::test_moe_through_pipeline``).

One world of each size (``tests/torch_world.py``) runs every case of the
module; JAX's side runs in the pytest process on its forced CPU devices
and the weights cross from JAX's init.  The limits are JAX's own: loss
rtol/atol 2e-5, grads rtol 5e-4 / atol 5e-5, the eval metrics rtol 1e-3
/ atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.models import sharding as jshard
from megatron_llm_tpu.models.transformer import rope_tables as jrope
from megatron_llm_tpu.parallel import cross_entropy as jce
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu.parallel import pipeline as jpipe
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.parallel import mesh as tmesh
from megatron_llm_tpu_torch.parallel import pipeline as tpipe

import torch_world

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
METRICS = ("perplexity", "accuracy", "instruct_accuracy",
           "count_loss_mask", "count_instruct_mask")

# test_pipeline_matches_reference's (dp, pp, tp, vpp, M) cases run in
# tests/test_torch_pipeline_reference.py (worlds of 2 and 4) and
# tests/test_torch_pipeline_train.py (dp2 x pp2 x tp2, a world of 8)
WINDOWS = {(6, 1): (3,), (5, 1): (2,), (4, 2): (3, 2)}   # (M, vpp): W
EVAL = [(2, 1), (2, 2), (4, 1)]
FALCON = dict(num_layers=4, num_kv_heads=1, norm_type="layernorm",
              activation="gelu", parallel_attn=True, parallel_layernorm=True,
              use_bias=False, qkv_bias=True, tie_embed_logits=True)


def _model_kw(num_layers=4, **kw):
    return dict(dict(num_layers=num_layers, params_dtype="float32",
                     recompute="none", seq_length=32,
                     max_position_embeddings=32), **kw)


def _batch(kw, M, mb, seed=0, mixed=False):
    g = np.random.default_rng(seed)
    v, s = jtiny(**kw).vocab_size, kw["seq_length"]
    out = {"tokens": g.integers(0, v, (M, mb, s)).astype(np.int64),
           "labels": g.integers(0, v, (M, mb, s)).astype(np.int64)}
    out["loss_mask"] = (g.choice([0.0, 0.3, 1.0], (M, mb, s)) if mixed
                        else np.ones((M, mb, s))).astype(np.float32)
    return out


def _jparams(kw, seed=0):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed),
                                                   jtiny(**kw)))


def _meta(kw, dp=1, pp=2, tp=1, vpp=1, M=1, **extra):
    return dict(dict(model=("tiny_config", kw),
                     parallel=dict(data_parallel=dp, pipeline_parallel=pp,
                                   tensor_parallel=tp,
                                   virtual_pipeline_stages=vpp,
                                   num_microbatches=M),
                     train=dict(seq_length=kw["seq_length"],
                                micro_batch_size=2,
                                global_batch_size=2 * dp * M)), **extra)


def case_inputs(degrees):
    """A reference case's model kwargs and batch (2 layers a chunk, 2
    rows a dp rank)."""
    dp, pp, tp, vpp, M = degrees
    kw = _model_kw(pp * vpp * 2)
    return kw, _batch(kw, M, 2 * dp)


def _window_case(M, vpp):
    kw = _model_kw(4 * vpp)
    return kw, _batch(kw, M, 2, seed=11)


def _eval_case(pp, vpp):
    kw = _model_kw(pp * vpp * 2)
    return kw, _batch(kw, 4, 2, seed=7, mixed=True)


MOE = _model_kw(4, num_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        jobs, names = [], []
        for pp, vpp in EVAL:
            if pp != world:
                continue
            kw, batch = _eval_case(pp, vpp)
            jobs.append(("pipeline_case",
                         {"params": _jparams(kw), "batch": batch},
                         _meta(kw, pp=pp, vpp=vpp, M=4, metrics=METRICS)))
            names.append(f"eval_pp{pp}_vpp{vpp}")
        if world == 2:
            for (M, vpp), ws in WINDOWS.items():
                kw, batch = _window_case(M, vpp)
                jobs.append(("pipeline_case",
                             {"params": _jparams(kw, 3), "batch": batch},
                             _meta(kw, vpp=vpp, M=M, windows=ws)))
                names.append(f"window_m{M}_vpp{vpp}")
            jobs.append(("pipeline_case",
                         {"params": _jparams(MOE),
                          "batch": _batch(MOE, 3, 2)},
                         _meta(MOE, M=3)))
            names.append("moe")
        else:
            kw = _model_kw(**FALCON)
            jobs.append(("pipeline_case",
                         {"params": _jparams(kw, 1),
                          "batch": _batch(kw, 3, 2, seed=5)},
                         _meta(dict(kw, norm_impl="pallas"), tp=2, M=3)))
            names.append("falcon")
        tmp = tmp_path_factory.mktemp(f"pipe{world}")
        out.update(zip(names, torch_world.run_world(world, tmp, jobs)))
    return out


def _reference(kw, params, batch):
    """JAX unpipelined: the mean over microbatches of the masked-mean CE,
    and its grads."""
    cfg = jtiny(**kw)
    rope = jrope(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        def one(m):
            logits = jm.forward(cfg, p, jb["tokens"][m], rope=rope)
            per = jce.cross_entropy(logits, jb["labels"][m],
                                    vocab_size=cfg.vocab_size)
            return jce.masked_mean_loss(per, jb["loss_mask"][m])
        return jnp.mean(jax.vmap(one)(jnp.arange(jb["tokens"].shape[0])))

    val, grads = jax.value_and_grad(loss)(params)
    return float(val), jax.tree.map(np.asarray, grads)


def _jax_pipeline(kw, degrees, params, batch):
    """JAX's ``pipeline_loss`` and its grads (the layer stack back in
    ``[L, ...]``)."""
    dp, pp, tp, vpp, M = degrees
    cfg = jtiny(**kw)
    par = JPar(data_parallel=dp, pipeline_parallel=pp, tensor_parallel=tp,
               virtual_pipeline_stages=vpp, num_microbatches=M)
    mesh = jmesh.build_mesh(par)
    specs = jpipe.pipeline_param_specs(jshard.param_specs(cfg, par), par)
    p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                     jpipe.to_pipeline_params(params, par), specs,
                     is_leaf=lambda v: isinstance(v, P))
    rt = JRun(model=cfg, parallel=par, optimizer=JOpt(),
              train=JTrain(seq_length=kw["seq_length"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jmesh.use_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: jpipe.pipeline_loss(rt, q, jb, mesh=mesh)))(p)
    return float(loss), jax.tree.map(
        np.asarray, jpipe.from_pipeline_params(grads, par))


def _assert_grads(got, want, what):
    flat_g = torch_world.flatten(got)
    flat_w = torch_world.flatten(want)
    assert set(flat_g) == set(flat_w), (set(flat_g) ^ set(flat_w))
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], w, **GRAD_TOL,
                                   err_msg=f"{what}: grad of {k}")


def test_stage_layout_roundtrip():
    """``to_pipeline_params`` / ``from_pipeline_params`` round-trip, and
    each staged leaf equals JAX's staged leaf."""
    kw = _model_kw(8)
    params = _jparams(kw, 1)
    par = TPar(pipeline_parallel=2, virtual_pipeline_stages=2)
    t = torch_world._t(params)
    staged = tpipe.to_pipeline_params(t, par)
    want = jpipe.to_pipeline_params(params, JPar(
        pipeline_parallel=2, virtual_pipeline_stages=2))
    for k, x in torch_world.flatten(staged).items():
        np.testing.assert_array_equal(x.numpy(),
                                      torch_world.flatten(want)[k])
    back = tpipe.from_pipeline_params(staged, par)
    for k, x in torch_world.flatten(back).items():
        np.testing.assert_array_equal(x.numpy(),
                                      torch_world.flatten(params)[k])
    specs = tpipe.pipeline_param_specs({"layers": {"w": (None, "tp")},
                                        "final_norm": (None,)}, par)
    assert specs == {"layers": {"w": (None, "pp", None, "tp")},
                     "final_norm": (None,)}
    assert tuple(jpipe.stage_layer_specs({"w": P(None, "tp")})["w"]) == \
        specs["layers"]["w"]


def test_interleaved_layer_assignment():
    """Chunk v on stage s holds global layers ``(v * pp + s) * lpc ..``,
    as JAX's, and ``parallel/mesh.pipeline_stage_layers`` agrees."""
    L, pp, vpp = 8, 2, 2
    staged = tpipe.to_stage_layers(torch.arange(L), pp, vpp)
    assert tuple(staged.shape) == (vpp, pp, L // (pp * vpp))
    want = np.asarray(jpipe.to_stage_layers(jnp.arange(L), pp, vpp))
    np.testing.assert_array_equal(staged.numpy(), want)
    assert staged[1, 0].tolist() == [4, 5]
    assert tmesh.pipeline_stage_layers(L, pp, vpp) == \
        jmesh.pipeline_stage_layers(L, pp, vpp) == [2] * 4
    assert tpipe.layers_per_chunk(L, pp, vpp) == jpipe.layers_per_chunk(
        L, pp, vpp)


def test_falcon_style_pipeline_matches_reference(worlds):
    """MQA, parallel attention and parallel LayerNorm (through the
    LayerNorm kernels' plain versions) at pp = 2 x tp = 2."""
    kw = _model_kw(**FALCON)
    batch = _batch(kw, 3, 2, seed=5)
    loss, grads = _reference(kw, _jparams(kw, 1), batch)
    out = worlds["falcon"]
    np.testing.assert_allclose(float(out["loss"]), loss, **LOSS_TOL)
    _assert_grads(out["grads"], grads, "falcon pp2 tp2")


@pytest.mark.parametrize("M,vpp", list(WINDOWS))
def test_windowed_remat_matches_unwindowed(worlds, M, vpp):
    """``pipeline_remat_window`` changes no result: the loss and every
    grad equal the plain schedule's bit for bit (the port's 1F1B already
    bounds in-flight work, so the window has nothing to bound), and the
    plain schedule's equal JAX's windowed pipeline."""
    out = worlds[f"window_m{M}_vpp{vpp}"]
    for w in WINDOWS[(M, vpp)]:
        assert float(out[f"loss_w{w}"]) == float(out["loss"])
        for k, x in torch_world.flatten(out["grads"]).items():
            np.testing.assert_array_equal(
                torch_world.flatten(out[f"grads_w{w}"])[k], x)
    kw, batch = _window_case(M, vpp)
    loss, _ = _reference(kw, _jparams(kw, 3), batch)
    np.testing.assert_allclose(float(out["loss"]), loss, **LOSS_TOL)


def test_window_with_vpp_requires_divisible_microbatches():
    TPar(pipeline_parallel=2, virtual_pipeline_stages=2, num_microbatches=4,
         pipeline_remat_window=4).validate()
    with pytest.raises(ValueError, match="divisible"):
        TPar(pipeline_parallel=2, virtual_pipeline_stages=2,
             num_microbatches=5, pipeline_remat_window=4).validate()
    with pytest.raises(ValueError, match="W > 0"):
        TPar(pipeline_parallel=2, pipeline_remat_window=-2).validate()


def test_auto_remat_window_equals_jax():
    from megatron_llm_tpu_torch.config import tiny_config as ttiny

    for M in (4, 20, 64):
        cfg = dict(num_layers=4, recompute="full")
        assert tpipe.auto_remat_window(ttiny(**cfg), pp=2, vpp=1, M=M) == \
            jpipe.auto_remat_window(jtiny(**cfg), pp=2, vpp=1, M=M)


@pytest.mark.parametrize("pp,vpp", EVAL)
def test_pipeline_eval_metrics_match_jax(worlds, pp, vpp):
    """``make_pipeline_eval_step``'s loss and registry metrics equal JAX's
    pipelined eval step's and its unpipelined eval step's."""
    kw, batch = _eval_case(pp, vpp)
    out = worlds[f"eval_pp{pp}_vpp{vpp}"]
    params = _jparams(kw)
    cfg = jtiny(**kw)
    par = JPar(pipeline_parallel=pp, virtual_pipeline_stages=vpp,
               num_microbatches=4)
    train = JTrain(seq_length=kw["seq_length"], metrics=METRICS)
    mesh = jmesh.build_mesh(par)
    specs = jpipe.pipeline_param_specs(jshard.param_specs(cfg, par), par)
    p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                     jpipe.to_pipeline_params(params, par), specs,
                     is_leaf=lambda v: isinstance(v, P))
    with jmesh.use_mesh(mesh):
        pipe_out = jax.device_get(jdriver.make_pipeline_eval_step(
            JRun(model=cfg, parallel=par, optimizer=JOpt(), train=train),
            mesh, METRICS)(p, batch))
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    ref_out = jax.device_get(jdriver.make_eval_step(
        JRun(model=cfg, optimizer=JOpt(), train=train), METRICS)(params,
                                                                  flat))
    assert set(out) == set(pipe_out) == set(ref_out)
    for k in pipe_out:
        np.testing.assert_allclose(out[k], pipe_out[k], **METRIC_TOL,
                                   err_msg=f"{k} vs JAX's pipeline")
        np.testing.assert_allclose(out[k], ref_out[k], **METRIC_TOL,
                                   err_msg=f"{k} vs JAX unpipelined")


def test_moe_through_pipeline(worlds):
    """A MoE model (4 experts, top-2) at pp = 2: the loss with its aux
    term and every grad (the router's through the combine and the aux)
    equal JAX's ``pipeline_loss``.  The draws hold no ties between router
    probabilities (``torch.topk`` and ``lax.top_k`` may break them
    differently)."""
    out = worlds["moe"]
    batch = _batch(MOE, 3, 2)
    loss, grads = _jax_pipeline(MOE, (1, 2, 1, 1, 3), _jparams(MOE), batch)
    assert np.isfinite(float(out["loss"]))
    np.testing.assert_allclose(float(out["loss"]), loss, **LOSS_TOL)
    _assert_grads(out["grads"], grads, "moe pp2")
    assert np.abs(torch_world.flatten(out["grads"])[
        "layers/mlp/router"]).sum() > 0


def test_schedule_runs_every_action_once():
    """Pure Python over many (pp, vpp, M): every stage runs each
    microbatch's forward and backward of each chunk once, a forward's
    input arrives the step after its producer ran it, the last stage's
    head sees every microbatch, and a stage holds at most the
    reference's in-flight count (1F1B: pp - stage; interleaved: its
    warmup plus one)."""
    for pp in (2, 3, 4):
        for vpp in (1, 2, 3):
            for M in sorted({pp, pp + 1, 2 * pp, 3 * pp + 1}):
                steps = tpipe.build_schedule(pp, vpp, M)
                seen = {}
                for t, row in enumerate(steps):
                    for s, a in enumerate(row):
                        if a is not None:
                            assert (s,) + a not in seen, (pp, vpp, M, a)
                            seen[(s,) + a] = (t,)
                for s in range(pp):
                    for kind in "FB":
                        got = sorted((m, c) for (s2, k, m, c) in seen
                                     if s2 == s and k == kind)
                        assert got == [(m, c) for m in range(M)
                                       for c in range(vpp)], (pp, vpp, M)
                for (s, k, m, c), (t,) in seen.items():
                    if k == "F" and not (s == 0 and c == 0):
                        src = (s - 1, c) if s else (pp - 1, c - 1)
                        assert seen[(src[0], "F", m, src[1])][0] < t
                    if k == "B":
                        assert seen[(s, "F", m, c)][0] < t
                most = tpipe.max_in_flight(pp, vpp, M)
                if vpp == 1:
                    assert most == [min(pp - s, M) for s in range(pp)]
                elif M % pp == 0 and M > pp:
                    assert most == [min((pp - s - 1) * 2 + (vpp - 1) * pp
                                        + 1, M * vpp) for s in range(pp)]


def test_forward_order_is_jax_tight_order():
    """``tight_indices`` equals JAX's, and every stage's forwards in the
    built schedule run in that order (whole groups of pp microbatches);
    under ``M % pp`` the short last group follows, through every chunk."""
    for pp in (2, 3, 4):
        for vpp in (1, 2, 3):
            for M in sorted({pp, pp + 1, 2 * pp, 3 * pp + 1}):
                whole = M - M % pp
                tight = [tpipe.tight_indices(rel, pp, vpp)
                         for rel in range(whole * vpp)]
                assert tight == [tuple(int(i) for i in jpipe.tight_indices(
                    rel, pp, vpp)) for rel in range(whole * vpp)]
                want = tight + [(m, c) for c in range(vpp)
                                for m in range(whole, M)]
                for s in range(pp):
                    got = [(a[1], a[2]) for row in tpipe.build_schedule(
                        pp, vpp, M) if (a := row[s]) is not None
                        and a[0] == "F"]
                    assert got == want, (pp, vpp, M, s)


def test_activation_bytes_describe_the_schedule():
    """The port's memory model counts the schedule's in-flight forwards
    (not JAX's scan's ``M * vpp + pp - 1`` boundaries)."""
    from megatron_llm_tpu_torch.config import tiny_config as ttiny

    cfg = ttiny(num_layers=8, recompute="full")
    est = tpipe.pipeline_activation_bytes(cfg, pp=2, vpp=1, M=16, mb=1,
                                          seq_shard=32)
    assert est["in_flight"] == 2
    per = 32 * cfg.hidden_size * 4
    assert est["boundary"] == (2 * 2 + 4) * per
    assert est["layer_residuals"] == 2 * 4 * 1 * per
    jax_est = jpipe.pipeline_activation_bytes(
        jtiny(num_layers=8, recompute="full"), pp=2, vpp=1, M=16, mb=1,
        seq_shard=32)
    assert est["boundary"] < jax_est["boundary"]


def test_combinations_left_out_raise():
    """Every combination JAX runs validates: pp x cp (JAX runs the ring
    inside its pipeline; ``tests/test_torch_pipeline_cp.py`` trains it),
    and MoE with cp or sequence parallelism
    (``tests/test_torch_moe_layouts.py``).  What JAX refuses still
    raises: zigzag under pp (JAX ``config.py:494-498``), a layer count
    that does not divide into the pipeline's chunks (where the stages are
    laid out, JAX ``parallel/mesh.py:134``), and a custom loss under the
    pipeline without a ``pipeline_loss_fn`` (JAX ``step.py:276-280``)."""
    from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
    from megatron_llm_tpu_torch.config import TrainConfig as TTrain
    from megatron_llm_tpu_torch.config import tiny_config as ttiny

    for model, par in (
            (ttiny(num_layers=4), TPar(pipeline_parallel=2,
                                       context_parallel=2)),
            (ttiny(num_experts=4), TPar(context_parallel=2)),
            (ttiny(num_experts=4), TPar(tensor_parallel=2,
                                        sequence_parallel=True))):
        cfg = TRun(model=model, parallel=par,
                   train=TTrain(seq_length=32)).validate()
        assert cfg.parallel.world_size in (2, 4)
    with pytest.raises(ValueError, match="zigzag"):
        TRun(model=ttiny(num_layers=4), parallel=TPar(
            pipeline_parallel=2, context_parallel=2,
            context_parallel_layout="zigzag"),
            train=TTrain(seq_length=32)).validate()
    with pytest.raises(ValueError, match="divide"):
        tpipe.to_pipeline_params({"layers": {"w": torch.zeros(3, 2)}},
                                 TPar(pipeline_parallel=2))
    from megatron_llm_tpu_torch.training import driver as tdriver

    cfg = TRun(model=ttiny(num_layers=4), parallel=TPar(pipeline_parallel=2),
               train=TTrain(seq_length=32)).validate()
    with pytest.raises(NotImplementedError, match="pipeline_loss_fn"):
        tdriver.pretrain_custom(cfg, None, {}, lambda *a: None,
                                device="cpu")
