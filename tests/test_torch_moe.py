"""Mixture of experts and expert parallelism: the port's ``moe_block``,
MoE model and ep-sharded runs in gloo worlds of 2 and 4 CPU ranks against
the JAX package (mirror of ``tests/models/test_moe.py``; the MoE model
through the pipeline is in ``tests/test_torch_pipeline.py``).

``torch.topk`` and ``lax.top_k`` may break ties between equal router
probabilities differently, so every input here is drawn from normal
distributions (no ties); the capacity-overflow case shrinks the capacity
instead of zeroing the router.  The limits are JAX's: outputs and the ep
forward 2e-5, the train losses 1e-4; the grads JAX's pipeline limits
(rtol 5e-4, atol 5e-5).
"""

import dataclasses
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
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.models import moe as jmoe
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch.config import ModelConfig as TModel
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.models import moe as tmoe
from megatron_llm_tpu_torch.utils.tree import tree_map

import torch_world

torch.set_num_threads(1)

# JAX's model functions as one program a config and shape (called eagerly,
# each op of the model compiles on its own)
_jforward = jax.jit(jm.forward, static_argnums=0,
                    static_argnames="return_aux")

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, num_kv_heads=4, ffn_hidden_size=64,
            max_position_embeddings=64, seq_length=32,
            params_dtype="float32", attention_impl="dot", recompute="none",
            make_vocab_size_divisible_by=8, num_experts=4, moe_top_k=2)
TRAIN = dict(train_iters=2, micro_batch_size=2, global_batch_size=4,
             seq_length=32, log_interval=1)
OPT = dict(lr=1e-3, clip_grad=1.0)
# ep train steps: name → parallel degrees (a world each)
STEPS = {"ep2": dict(expert_parallel=2),
         "dp2_ep2_zero1": dict(data_parallel=2, expert_parallel=2,
                               use_distributed_optimizer=True)}


def _jcfg(**kw):
    return JModel(**dict(BASE, **kw)).validate()


def _tcfg(**kw):
    return TModel(**dict(BASE, **kw)).validate()


def _tokens(seed, shape=(2, 32)):
    return np.random.default_rng(seed).integers(0, 64, shape)


def _jparams(seed=0):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed),
                                                   _jcfg()))


def _batches(seed=5, n=2):
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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world, ep_world in ((2, dict(expert_parallel=2)),
                            (4, dict(data_parallel=2, expert_parallel=2))):
        jobs = [("moe_forward_case",
                 {"params": _jparams(), "tokens": _tokens(4, (4, 32))},
                 dict(model=("ModelConfig", BASE), parallel=ep_world,
                      train=dict(seq_length=32, micro_batch_size=4 // max(
                          1, ep_world.get("data_parallel", 1)),
                          global_batch_size=4)))]
        names = [f"forward_{world}"]
        if world == 4:
            jobs.append(("grads_case",
                         {"params": _jparams(), "batch": _grad_batch()},
                         dict(model=("ModelConfig", BASE),
                              parallel=dict(tensor_parallel=2,
                                            expert_parallel=2),
                              train=dict(seq_length=32, micro_batch_size=4,
                                         global_batch_size=4))))
            names.append("tp2_ep2_grads")
        for name, par in STEPS.items():
            size = par.get("data_parallel", 1) * par["expert_parallel"]
            if size == world:
                jobs.append(("pretrain_case",
                             {"params": _jparams(), "batches": _batches()},
                             dict(model=("ModelConfig", BASE), parallel=par,
                                  optimizer=OPT, train=TRAIN)))
                names.append(name)
        tmp = tmp_path_factory.mktemp(f"moe{world}")
        out.update(zip(names, torch_world.run_world(world, tmp, jobs)))
    return out


def _grad_batch():
    g = np.random.default_rng(6)
    toks = g.integers(0, 64, (4, 32))
    return {"tokens": toks.astype(np.int64),
            "labels": np.roll(toks, -1, -1).astype(np.int64),
            "loss_mask": (g.random((4, 32)) > 0.2).astype(np.float32)}


def test_moe_tp2_ep2_loss_and_grads_match_jax(worlds):
    """tp = 2 x ep = 2: each expert's ffn split over tp as the dense MLP's
    (the down projection reduced over tp before the combine) and the
    experts over ep; one microbatch's loss, aux term included, and the
    gathered grads equal JAX's unsharded ones."""
    from megatron_llm_tpu.training import step as jstep

    rt = JRun(model=_jcfg(), optimizer=JOpt(),
              train=JTrain(seq_length=32)).validate()
    jb = {k: jnp.asarray(v) for k, v in _grad_batch().items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.compute_loss(rt, p, jb)))(
            jax.tree.map(jnp.asarray, _jparams()))
    out = worlds["tp2_ep2_grads"]
    np.testing.assert_allclose(float(out["loss"]), float(loss), **OUT_TOL)
    flat = torch_world.flatten(out["grads"])
    for k, w in torch_world.flatten(jax.tree.map(np.asarray,
                                                 grads)).items():
        np.testing.assert_allclose(flat[k], w, **GRAD_TOL, err_msg=k)


def _blocks(**kw):
    """JAX's and the port's ``moe_block`` on the same layer params and a
    normal ``x``."""
    jc, tc = _jcfg(**kw), _tcfg(**kw)
    p = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.key(1), jc))
    x = np.random.default_rng(1).normal(size=(2, 32, 32)).astype(np.float32)
    jo, js = jmoe.moe_block(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    to, ts = tmoe.moe_block(tc, params_from_jax(p, device="cpu"),
                            torch.from_numpy(x))
    return (np.asarray(jo), jax.tree.map(np.asarray, js)), \
        (to.numpy(), {k: v.numpy() for k, v in ts.items()})


@pytest.mark.parametrize("kw", [dict(moe_top_k=1),
                                dict(moe_top_k=2),
                                dict(moe_top_k=2, moe_capacity_factor=0.25,
                                     moe_group_size=16)],
                         ids=["top1", "top2", "capacity_overflow"])
def test_moe_block_matches_jax(kw):
    """The routed MLP's output, aux loss, dropped fraction and per-expert
    load equal JAX's: top-1 (Switch's un-renormalized gate), top-2
    (renormalized), and a capacity of a quarter of the balanced one with
    routing groups of 16, where most assignments overflow."""
    (jo, js), (to, ts) = _blocks(**kw)
    np.testing.assert_allclose(to, jo, **OUT_TOL)
    for k in ("aux", "dropped", "load"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    if "moe_capacity_factor" in kw:
        assert float(ts["dropped"]) > 0.5
    np.testing.assert_allclose(ts["load"].sum(), 1.0, rtol=1e-6)


def test_capacity_and_group_size_equal_jax():
    for kw in (dict(), dict(moe_top_k=1, moe_capacity_factor=0.1),
               dict(num_experts=8, moe_group_size=12)):
        for n in (32, 30, 7):
            assert tmoe.capacity(_tcfg(**kw), n) == jmoe.capacity(
                _jcfg(**kw), n)
            assert tmoe.group_size(_tcfg(**kw), n) == jmoe.group_size(
                _jcfg(**kw), n)


def test_moe_model_forward_and_grad_match_jax():
    """The MoE model's logits and aux, and the grads of ``mean(logits^2)
    + 0.01 aux`` (the router's through the combine weights and the aux
    loss), equal JAX's."""
    jc, tc = _jcfg(), _tcfg()
    jp = jm.init_params(jax.random.key(0), jc)
    tokens = _tokens(3)

    def jloss(p):
        lg, a = _jforward(jc, p, jnp.asarray(tokens), return_aux=True)
        return jnp.mean(lg ** 2) + 0.01 * jmoe.aux_loss_of(a), (lg, a)

    (_, (jlg, jaux)), jg = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jp)
    live = tree_map(lambda t: t.requires_grad_(True),
                    params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    lg, aux = tm.forward(tc, live, torch.from_numpy(tokens), return_aux=True)
    (torch.mean(lg ** 2) + 0.01 * tmoe.aux_loss_of(aux)).backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux["aux"]), float(jaux["aux"]),
                               rtol=1e-6)
    flat = torch_world.flatten(tree_map(lambda t: t.grad.numpy(), live))
    for k, w in torch_world.flatten(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(flat[k], w, **GRAD_TOL, err_msg=k)
    assert np.abs(flat["layers/mlp/router"]).sum() > 0
    assert live["layers"]["mlp"]["router"].dtype == torch.float32


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ep_sharded_matches_unsharded(worlds, world):
    """At ep = 2 (a world of 2) and dp = 2 x ep = 2 (a world of 4) each rank
    holds half the experts and runs them on its slice of the dispatch;
    the combine summed over ep gives JAX's unsharded logits."""
    want = _jforward(_jcfg(), jax.tree.map(jnp.asarray, _jparams()),
                      jnp.asarray(_tokens(4, (4, 32))))
    np.testing.assert_allclose(worlds[f"forward_{world}"]["logits"],
                               np.asarray(want), **OUT_TOL)


def _jax_losses(par, capsys):
    jc = JRun(model=_jcfg(), parallel=JPar(**par), optimizer=JOpt(**OPT),
              train=JTrain(**TRAIN)).validate()
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _batches().items()}
    capsys.readouterr()
    jdriver.pretrain(jc, params=jax.tree.map(jnp.asarray, _jparams()),
                     batch_provider=_provider(batches))
    out = capsys.readouterr().out
    return [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]


@pytest.mark.parametrize("name", list(STEPS))
def test_moe_train_step_ep_matches_jax(worlds, name, capsys):
    """Two steps of the port's ``pretrain`` at ep = 2 and at dp = 2 x ep = 2
    with ZeRO-1 log JAX's driver's losses at the same degrees and at ep =
    1 (JAX's limit)."""
    got = worlds[name]["losses"]
    want = _jax_losses(STEPS[name], capsys)
    ref = _jax_losses({"data_parallel": STEPS[name].get("data_parallel", 1)},
                      capsys)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **STEP_TOL)
    np.testing.assert_allclose(got, ref, **STEP_TOL)


def test_moe_train_metrics():
    """The step's routing observability: the dropped fraction, the load
    imbalance (E * max f_e, 1 when balanced) and the aux loss."""
    from megatron_llm_tpu_torch.training import step as tstep

    cfg = TRun(model=_tcfg(), optimizer=TOpt(**OPT),
               train=TTrain(**TRAIN)).validate()
    params = params_from_jax(_jparams(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches()["0"].items()}
    state = tstep.init_train_state(cfg, params)
    _, m = tstep.make_train_step(cfg, device="cpu")(state, batch)
    assert 0.0 <= float(m["moe_dropped_frac"]) <= 1.0
    assert float(m["moe_load_imbalance"]) >= 0.99
    assert np.isfinite(float(m["moe_aux_loss"]))
    assert float(m["moe_aux_loss"]) >= 0.99


def test_expert_parallel_validation():
    with pytest.raises(ValueError, match="requires a MoE model"):
        TRun(model=_tcfg(num_experts=0), parallel=TPar(expert_parallel=2),
             train=TTrain(seq_length=32)).validate()
    with pytest.raises(ValueError, match="must divide"):
        TRun(model=_tcfg(num_experts=3, moe_top_k=1),
             parallel=TPar(expert_parallel=2),
             train=TTrain(seq_length=32)).validate()
    from megatron_llm_tpu.models import sharding as jshard
    from megatron_llm_tpu_torch.models import sharding as tshard

    par = dict(expert_parallel=2)
    got = tshard.param_specs(_tcfg(), TPar(**par))["layers"]["mlp"]
    want = jshard.param_specs(_jcfg(), JPar(**par))["layers"]["mlp"]
    assert got == {k: tuple(v) for k, v in want.items()}


def test_lora_refuses_mlp_targets_on_moe():
    """LoRA training takes attention targets only on a MoE model (JAX
    ``lora.py:49-54``)."""
    from megatron_llm_tpu_torch.training import lora as tlora

    cfg = TRun(model=_tcfg(), train=TTrain(seq_length=32)).validate()
    with pytest.raises(ValueError, match="MoE"):
        tlora._check_targets(cfg, ("wq", "w_down"))
    tlora._check_targets(cfg, ("wq", "wv"))


def test_moe_serves_composed_and_matches_jax_tokens():
    """A tiny MoE model serves through the composed route (the fused
    decode step refuses MoE, as JAX's eligibility does): greedy tokens
    equal the JAX engine's."""
    from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
    from megatron_llm_tpu.serving import ServingEngine as JServingEngine
    from megatron_llm_tpu_torch.kernels.decode_step import _stack_eligible
    from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine

    kw = dict(vocab_size=256, hidden_size=256, num_attention_heads=2,
              num_kv_heads=2, ffn_hidden_size=128, num_layers=2,
              max_position_embeddings=64, seq_length=64)
    jc, tc = _jcfg(**kw), _tcfg(**kw)
    jp = jm.init_params(jax.random.key(2), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert _stack_eligible(tc, tp) is None
    prompts = [_tokens(7 + i, (5 + 3 * i,)).tolist() for i in range(3)]
    news = (6, 4, 7)
    ecfg = dict(max_batch_size=2, max_seq_len=64, prefill_bucket=8)

    def run(engine):
        engine.start()
        try:
            hs = [engine.submit([t + 1 for t in p], n, use_eos_stop=False)
                  for p, n in zip(prompts, news)]
            return [h.result(600).tokens for h in hs]
        finally:
            engine.shutdown()

    want = run(JServingEngine(jc, jp, JEngineConfig(**ecfg)))
    got = run(ServingEngine(tc, tp, EngineConfig(**ecfg), device="cpu"))
    assert got == want


def test_init_moe_params_shapes():
    """``init_moe_params``: one layer's router ``[h, E]`` (fp32) and the
    expert-stacked weights, as JAX's."""
    tc = _tcfg()
    p = tmoe.init_moe_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = jmoe.init_moe_params(jax.random.key(0), _jcfg())
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert p["router"].dtype == torch.float32
    stats = tmoe.stats_zero(tc)
    assert set(stats) == set(jmoe.stats_zero(_jcfg()))
    assert dataclasses.replace(tc, num_experts=0).num_experts == 0
