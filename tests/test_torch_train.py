"""The port's training path against the JAX package's, on the CPU.

Weights are the JAX package's (``init_params`` from a JAX key) carried
across with ``params_from_jax``; batches are made with numpy from a seed
and handed to both.  With ``attention_impl="flash"`` / ``norm_impl="pallas"``
the JAX side runs its Pallas kernels, forward and backward, in interpret
mode and the port its kernels' plain versions (CPU tensors).
"""

import dataclasses
import math
import re
import sys
from pathlib import Path

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
from megatron_llm_tpu.data import samplers as jsamplers
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.parallel import cross_entropy as jce
from megatron_llm_tpu.resilience import anomaly as janomaly
from megatron_llm_tpu.training import microbatches as jmb
from megatron_llm_tpu.training import optimizer as jopt
from megatron_llm_tpu.training import schedule as jsched
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import ParallelConfig as TPar
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.data import samplers as tsamplers
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.parallel import cross_entropy as tce
from megatron_llm_tpu_torch.resilience import anomaly as tanomaly
from megatron_llm_tpu_torch.training import driver as tdriver
from megatron_llm_tpu_torch.training import microbatches as tmb
from megatron_llm_tpu_torch.training import optimizer as topt
from megatron_llm_tpu_torch.training import schedule as tsched
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.timers import Timers
from megatron_llm_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

# JAX's model functions as one program a config and shape (called eagerly,
# each op of the model compiles on its own)
_jforward = jax.jit(jm.forward, static_argnums=0,
                    static_argnames="return_aux")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(model_kw=None, opt_kw=None, train_kw=None):
    model_kw = dict(model_kw or {})
    opt_kw = dict(dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1,
                       weight_decay=0.1, clip_grad=1.0), **(opt_kw or {}))
    train_kw = dict(dict(train_iters=10, micro_batch_size=2,
                         global_batch_size=4, seq_length=16),
                    **(train_kw or {}))
    jc = JRun(model=jtiny(**model_kw), parallel=JPar(),
              optimizer=JOpt(**opt_kw), train=JTrain(**train_kw)).validate()
    tc = TRun(model=ttiny(**model_kw), optimizer=TOpt(**opt_kw),
              train=TTrain(**train_kw)).validate()
    return jc, tc


def _batch(cfg, seed, accum):
    rng = np.random.default_rng(seed)
    shape = (accum, cfg.train.micro_batch_size, cfg.train.seq_length)
    tokens = rng.integers(0, cfg.model.vocab_size, shape).astype(np.int32)
    mask = (rng.random(shape) > 0.1).astype(np.float32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
            "loss_mask": mask}


# ---------------------------------------------------------------------------
# Cross entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing,vocab", [(0.0, None), (0.0, 50),
                                             (0.1, 50), (0.2, None)])
def test_cross_entropy_and_grad_match_jax(smoothing, vocab):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 56)).astype(np.float32) * 3
    targets = rng.integers(0, vocab or 56, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)

    def jloss(lg):
        per = jce.cross_entropy(lg, jnp.asarray(targets), smoothing, vocab)
        return jce.masked_mean_loss(per, jnp.asarray(mask)), per

    (j_loss, j_per), j_grad = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(logits))
    tl = _t(logits).requires_grad_(True)
    t_per = tce.cross_entropy(tl, _t(targets), smoothing, vocab)
    t_loss = tce.masked_mean_loss(t_per, _t(mask))
    (t_grad,) = torch.autograd.grad(t_loss, tl)
    np.testing.assert_allclose(t_per.detach().numpy(), np.asarray(j_per),
                               rtol=1e-6, atol=1e-5)
    assert t_loss.item() == pytest.approx(float(j_loss), rel=1e-6)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-7)


def test_masked_mean_loss_empty_mask():
    per = torch.ones(2, 3)
    assert float(tce.masked_mean_loss(per, torch.zeros(2, 3))) == 0.0


# ---------------------------------------------------------------------------
# Optimizer, clipping, loss scaler
# ---------------------------------------------------------------------------


def _param_tree(rng, dtype):
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.5

    tree = {"layers": {"attn": {"wq": a(2, 8, 8), "bq": a(2, 8)},
                       "input_norm": {"scale": 1.0 + a(2, 8) * 0.1}},
            "lm_head": a(8, 16)}
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


@pytest.mark.parametrize("optimizer,dtype", [("adamw", jnp.float32),
                                             ("adamw", jnp.bfloat16),
                                             ("sgd", jnp.float32)])
def test_optimizer_steps_match_jax(optimizer, dtype):
    """Five clipped updates with schedules, fp32 masters for bf16 params
    (the port updates in place; JAX returns new trees)."""
    cfg_kw = dict(optimizer=optimizer, lr=1e-2, weight_decay=0.1,
                  clip_grad=0.5, lr_warmup_iters=2)
    jcfg, tcfg = JOpt(**cfg_kw), TOpt(**cfg_kw)
    rng = np.random.default_rng(1)
    jparams = _param_tree(rng, dtype)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    jstate = jopt.init_opt_state(jparams, jcfg)
    tstate = topt.init_opt_state(tparams, tcfg)
    assert (tstate.master is None) == (jstate.master is None)
    for it in range(5):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            jparams)
        tgrads = params_from_jax(_np_tree(grads), device="cpu")
        jg, jnorm = jopt.clip_by_global_norm(grads, jcfg.clip_grad)
        tg, tnorm = topt.clip_by_global_norm(tgrads, tcfg.clip_grad)
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
        lr = jsched.learning_rate(jcfg, jstate.step, 10)
        wd = jsched.weight_decay(jcfg, jstate.step, 10)
        jparams, jstate = jopt.optimizer_step(jcfg, jparams, jg, jstate, lr,
                                              wd)
        tparams, tstate = topt.optimizer_step(
            tcfg, tparams, tg, tstate, tsched.learning_rate(tcfg, it, 10),
            tsched.weight_decay(tcfg, it, 10))
    assert tstate.step == int(jstate.step) == 5
    pairs = [(tparams, jparams), (tstate.mu, jstate.mu)]
    if jstate.master is not None:
        pairs.append((tstate.master, jstate.master))
    if jstate.nu is not None:
        pairs.append((tstate.nu, jstate.nu))
    for t_tree, j_tree in pairs:
        for t, j in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
            j = np.asarray(j, np.float32)
            if t.dtype == torch.bfloat16:
                # both round the same fp32 master to bf16
                np.testing.assert_allclose(t.float().numpy(), j,
                                           rtol=2 ** -8, atol=1e-6)
            else:
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                           atol=1e-6)


def test_wd_mask_and_count_zeros_match_jax():
    rng = np.random.default_rng(2)
    jparams = _param_tree(rng, jnp.float32)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    want = jax.tree.leaves(jopt._wd_mask(jparams))
    assert tree_leaves(topt._wd_mask(tparams)) == want
    grads = jax.tree.map(lambda p: p.at[..., 0].set(0.0), jparams)
    assert int(topt.count_zeros(params_from_jax(_np_tree(grads),
                                                device="cpu"))) \
        == int(jopt.count_zeros(grads))


def test_dynamic_loss_scaler_matches_jax():
    cfg_kw = dict(initial_loss_scale=2.0 ** 10, loss_scale_window=3,
                  hysteresis=2, min_loss_scale=1.0)
    jcfg, tcfg = JOpt(**cfg_kw), TOpt(**cfg_kw)
    js, ts = jopt.init_dynamic_scaler(jcfg), topt.init_dynamic_scaler(tcfg)
    pattern = [0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0]
    for inf in pattern:
        js = jopt.scaler_update(js, jnp.asarray(bool(inf)), jcfg)
        ts = topt.scaler_update(ts, bool(inf), tcfg)
        assert (ts.scale, ts.growth_tracker, ts.hysteresis) == (
            float(js.scale), int(js.growth_tracker), int(js.hysteresis))
    const = topt.init_scaler(TOpt(loss_scale=128.0))
    jconst = jopt.init_scaler(JOpt(loss_scale=128.0))
    for inf in (0, 1, 0):
        const = topt.scaler_update(const, bool(inf), tcfg)
        jconst = jopt.scaler_update(jconst, jnp.asarray(bool(inf)), jcfg)
        assert (const.scale, const.growth_tracker, const.hysteresis) == (
            float(jconst.scale), int(jconst.growth_tracker),
            int(jconst.hysteresis))
    assert const.scale == 128.0


# ---------------------------------------------------------------------------
# Schedules and microbatch calculators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(lr_decay_style="cosine", lr_warmup_iters=3),
    dict(lr_decay_style="linear", lr_warmup_iters=0, lr_decay_iters=15),
    dict(lr_decay_style="constant", lr_warmup_fraction=0.2),
    dict(lr_decay_style="inverse-square-root", lr_warmup_iters=4),
    dict(start_weight_decay=0.01, end_weight_decay=0.1,
         weight_decay_incr_style="linear"),
    dict(start_weight_decay=0.01, end_weight_decay=0.1,
         weight_decay_incr_style="cosine"),
])
def test_schedules_match_jax(kw):
    jcfg, tcfg = JOpt(lr=3e-4, min_lr=3e-5, **kw), TOpt(lr=3e-4, min_lr=3e-5,
                                                       **kw)
    # the same fp32 operations; XLA's cos may differ from numpy's by an ulp
    for it in range(25):
        assert tsched.learning_rate(tcfg, it, 20) == pytest.approx(
            float(jsched.learning_rate(jcfg, it, 20)), rel=1e-6)
        assert tsched.weight_decay(tcfg, it, 20) == pytest.approx(
            float(jsched.weight_decay(jcfg, it, 20)), rel=1e-7)


@pytest.mark.parametrize("ramp", [None, (4, 4, 40), (8, 8, 0), (8, 4, 30)])
def test_microbatch_calculators_match_jax(ramp):
    jc = jmb.build_num_microbatches_calculator(16, 2, 2, ramp)
    tc = tmb.build_num_microbatches_calculator(16, 2, 2, ramp)
    for consumed in range(0, 80, 4):
        jc.update(consumed, True)
        tc.update(consumed, True)
        assert (tc.get(), tc.get_current_global_batch_size()) == (
            jc.get(), jc.get_current_global_batch_size())
    with pytest.raises(ValueError):
        tmb.build_num_microbatches_calculator(10, 4, 1)
    # a rung (6) that the micro batch x dp (4) does not divide
    with pytest.raises(ValueError):
        tmb.build_num_microbatches_calculator(16, 2, 2, (4, 2, 30)).update(
            8, True)


# ---------------------------------------------------------------------------
# Anomaly guard and skip semantics
# ---------------------------------------------------------------------------


def test_guard_update_matches_jax():
    losses = [2.0, 2.1, 1.9, 2.05, float("nan"), 2.0, 9.0, 1.95, 2.0, 8.5,
              2.02]
    infs = [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0]
    kw = dict(z_threshold=3.0, alpha=0.2, warmup_steps=3)
    jg, tg = janomaly.init_guard_state(), tanomaly.init_guard_state()
    for loss, inf in zip(losses, infs):
        jg, j_anom, j_data = janomaly.guard_update(
            jg, jnp.float32(loss), jnp.asarray(bool(inf)), **kw)
        tg, t_anom, t_data = tanomaly.guard_update(
            tg, torch.tensor(loss), torch.tensor(bool(inf)), **kw)
        assert (bool(t_anom), bool(t_data)) == (bool(j_anom), bool(j_data))
        for t, j in zip(tg, jg):
            assert float(t) == pytest.approx(float(j), rel=1e-6, abs=1e-7)


def _nan_loss(cfg, params, mb, rng, deterministic):
    return tstep.compute_loss(cfg, params, mb, rng) * float("nan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_loss_leaves_params_and_moments_bitwise(dtype):
    _, tc = _cfgs(dict(params_dtype=dtype))
    params = tm.init_params(tc.model, seed=0, device="cpu")
    state = tstep.init_train_state(tc, params)
    batch = tstep.to_device_batch(_batch(tc, 0, 2), "cpu")
    state, _ = tstep.train_step(tc, state, batch)      # moments non-zero
    before = tree_map(lambda t: t.clone(), {
        "params": state.params, "mu": state.opt.mu, "nu": state.opt.nu,
        "master": state.opt.master or {}})
    new, metrics = tstep.train_step(tc, state, batch, loss_fn=_nan_loss)
    assert metrics["skipped"] == 1 and int(metrics["anomaly"]) == 1
    assert new.skipped == 1 and new.iteration == 2 and new.opt.step == 1
    after = {"params": new.params, "mu": new.opt.mu, "nu": new.opt.nu,
             "master": new.opt.master or {}}
    for b, a in zip(tree_leaves(before), tree_leaves(after)):
        assert torch.equal(a, b)
    assert int(new.guard.run) == 1


def _lm_loss(cfg, params, mb, rng, deterministic):
    return tstep.compute_loss(cfg, params, mb, rng)


@pytest.mark.parametrize("custom", [False, True])
def test_leaf_the_loss_does_not_reach(custom):
    """A leaf cut off from the loss: the decoder-LM loss raises (a wiring
    fault), a custom loss gives it JAX's zero grad (the pooler under mean
    pooling)."""
    _, tc = _cfgs()
    params = dict(tm.init_params(tc.model, seed=0, device="cpu"),
                  cut_off=torch.ones(3))
    batch = tstep.to_device_batch(_batch(tc, 0, 1), "cpu")
    if not custom:
        with pytest.raises(RuntimeError, match="not have been used"):
            tstep._accumulate_grads(tc, params, batch, None, 1.0)
        return
    grads, loss = tstep._accumulate_grads(tc, params, batch, None, 1.0,
                                          loss_fn=_lm_loss)
    assert torch.equal(grads["cut_off"], torch.zeros(3))
    assert math.isfinite(float(loss))


# ---------------------------------------------------------------------------
# The slice as a whole: train steps against JAX make_train_step
# ---------------------------------------------------------------------------


def _run_both(model_kw, steps=3, accum=2, opt_kw=None):
    jc, tc = _cfgs(model_kw, opt_kw)
    jparams = jm.init_params(jax.random.key(0), jc.model)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(tc, tparams)
    jfn = jstep.make_train_step(jc)
    tfn = tstep.make_train_step(tc, "cpu")
    out = []
    for i in range(steps):
        batch = _batch(jc, 100 + i, accum)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, None)
        tstate, tmet = tfn(tstate, tstep.to_device_batch(batch, "cpu"))
        out.append((float(tmet["loss"]), float(jmet["loss"]),
                    float(tmet["grad_norm"]), float(jmet["grad_norm"])))
    return jstate, tstate, out


def _leaf_pairs(tstate, jstate):
    return zip(tree_leaves(tstate.params),
               jax.tree.leaves(_np_tree(jstate.params)))


def test_train_steps_match_jax_fp32_flash_pallas():
    """Three steps of a 2-layer fp32 llama with flash attention and the
    RMSNorm kernels (selective recompute on both sides), grad_accum 2:
    losses within 1e-5, params within 1e-4 relative."""
    jstate, tstate, out = _run_both(dict(attention_impl="flash",
                                         norm_impl="pallas",
                                         recompute="selective"))
    for t_loss, j_loss, t_norm, j_norm in out:
        assert t_loss == pytest.approx(j_loss, rel=1e-5, abs=1e-5)
        assert t_norm == pytest.approx(j_norm, rel=1e-4)
    for t, j in _leaf_pairs(tstate, jstate):
        rel = float(np.linalg.norm(t.numpy() - j) / np.linalg.norm(j))
        assert rel <= 1e-4, rel
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=2e-5)
    assert tstate.opt.step == int(jstate.opt.step) == 3


def test_train_steps_match_jax_bf16_with_fp32_master():
    """bf16 params with fp32 master weights: the forward and backward run
    in bf16 on both sides, which round at different places (2^-8
    relative per rounding), so losses agree within 1e-2.  Three steps
    move a master by far less than its size (0.2 % for the norm scales),
    so the masters themselves would agree under any update; each leaf's
    change from its initial value is held against JAX's instead, within
    0.1 relative (Frobenius).  Adam moves an element by about lr a step
    whatever its grad's size, so where a small grad's sign differs
    between the two bf16 paths the changes part: 0.07 for the embedding,
    under 0.01 for the norm scales on this input."""
    model_kw = dict(params_dtype="bfloat16", attention_impl="flash",
                    norm_impl="pallas")
    jc, _ = _cfgs(model_kw)
    init = jax.tree.leaves(_np_tree(jm.init_params(jax.random.key(0),
                                                   jc.model)))
    jstate, tstate, out = _run_both(model_kw)
    for t_loss, j_loss, t_norm, j_norm in out:
        assert t_loss == pytest.approx(j_loss, rel=1e-2)
        assert t_norm == pytest.approx(j_norm, rel=5e-2)
    masters = zip(tree_leaves(tstate.opt.master),
                  jax.tree.leaves(_np_tree(jstate.opt.master)), init)
    for t, j, i in masters:
        i = i.astype(np.float32)
        t_move, j_move = t.numpy() - i, j - i
        rel = float(np.linalg.norm(t_move - j_move) / np.linalg.norm(j_move))
        assert rel <= 0.1, rel


@pytest.mark.parametrize("attn,norm,recompute", [
    ("dot", "xla", "none"), ("dot", "pallas", "full"),
    ("flash", "xla", "selective")])
def test_one_step_matches_jax_across_impls(attn, norm, recompute):
    jstate, tstate, out = _run_both(dict(attention_impl=attn, norm_impl=norm,
                                         recompute=recompute), steps=1,
                                    accum=1)
    assert out[0][0] == pytest.approx(out[0][1], rel=1e-5, abs=1e-5)
    for t, j in _leaf_pairs(tstate, jstate):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=2e-5)


def test_recompute_policy_does_not_change_the_numbers():
    cfg = ttiny(attention_impl="flash", norm_impl="pallas")
    params = tm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)))
    grads = {}
    for policy in ("none", "selective", "full"):
        c = dataclasses.replace(cfg, recompute=policy)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tstep.tree_unflatten(params, leaves)
        out = tm.forward(c, live, toks)
        grads[policy] = torch.autograd.grad(out.square().mean(), leaves)
    for policy in ("selective", "full"):
        for a, b in zip(grads["none"], grads[policy]):
            assert torch.equal(a, b)


def test_forward_return_aux_and_flops_per_token_match_jax():
    jc, tc = _cfgs()
    jparams = jm.init_params(jax.random.key(0), jc.model)
    tparams = params_from_jax(_np_tree(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    j_logits, j_aux = _jforward(jc.model, jparams, jnp.asarray(toks),
                                 return_aux=True)
    t_logits, t_aux = tm.forward(tc.model, tparams, torch.from_numpy(toks),
                                 return_aux=True)
    assert float(t_aux) == float(j_aux) == 0.0
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    from megatron_llm_tpu.config import llama2_config as jllama2

    for kw in (dict(), dict(num_kv_heads=8), dict(num_layers=8)):
        for seq in (1024, 4096):
            assert tm.flops_per_token(tllama2("7b", **kw), seq) == \
                jm.flops_per_token(jllama2("7b", **kw), seq)


# ---------------------------------------------------------------------------
# Data, driver and entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle,consumed", [(False, 0), (False, 12),
                                              (True, 0), (True, 20)])
def test_batch_iterator_matches_jax(shuffle, consumed):
    ds = tfinetune._MockDataset(100, 8, n=40, seed=7)
    kw = dict(global_batch_size=4, grad_accum=2, seq_length=8,
              consumed_samples=consumed, shuffle=shuffle, seed=5,
              eod_token=3)
    j_it = iter(jsamplers.BatchIterator(ds, **kw))
    t_it = iter(tsamplers.BatchIterator(ds, **kw))
    for _ in range(6):
        jb, tb = next(j_it), next(t_it)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_mock_dataset_matches_the_jax_entry():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "jax_finetune", Path(__file__).resolve().parents[1] / "finetune.py")
    jfin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfin)
    a = jfin._MockDataset(500, 16, seed=1234)
    b = tfinetune._MockDataset(500, 16, seed=1234)
    assert len(a) == len(b)
    for i in (0, 1, 77):
        np.testing.assert_array_equal(a[i]["text"], b[i]["text"])


def test_pretrain_loop_skip_iters_exit_and_eval(capsys):
    _, tc = _cfgs(train_kw=dict(train_iters=6, skip_iters=(2,),
                                exit_interval=4, log_interval=1,
                                eval_interval=3, eval_iters=1))
    seen = []
    ds = tfinetune._MockDataset(tc.model.vocab_size, 16, n=64)
    state = tdriver.pretrain(tc, ds, valid_dataset=ds, device="cpu",
                             on_step=lambda it, m, s: seen.append(it))
    assert seen == [1, 3, 4]            # 2 skipped, exit after 4
    assert state.iteration == 4 and state.opt.step == 3
    out = capsys.readouterr().out
    assert "skipping iteration 2" in out and "exit_interval" in out
    assert "validation loss at iteration 3" in out


@pytest.mark.parametrize("train_kw,match", [
    (dict(wandb_project="proj"), "wandb requested but not installed"),
    (dict(metrics=("perplexity",)), "perplexity: "),
    (dict(metrics=("accuracy",)), "accuracy: "),
    (dict(profile_dir="trace"), "profiler: trace written"),
    (dict(tensorboard_dir="tb"), "training finished"),
])
def test_pretrain_refuses_what_is_not_ported(train_kw, match, tmp_path,
                                             capsys, monkeypatch):
    """The training I/O options, once refused, now run with the JAX
    driver's output; what the driver still refuses is a metric name the
    registry does not have (``ValueError``, as in JAX)."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    train_kw = {k: (str(tmp_path / v) if k.endswith("_dir") else v)
                for k, v in train_kw.items()}
    _, tc = _cfgs(train_kw=dict(train_kw, train_iters=2, eval_interval=2,
                                eval_iters=1, profile_step_start=1,
                                profile_step_end=1))
    ds = tfinetune._MockDataset(256, 16, n=64)
    tdriver.pretrain(tc, ds, valid_dataset=ds, device="cpu")
    assert re.search(match, capsys.readouterr().out)
    if "tensorboard_dir" in train_kw:
        assert list(Path(train_kw["tensorboard_dir"]).glob("events.*"))
    if "profile_dir" in train_kw:
        assert list(Path(train_kw["profile_dir"]).glob("trace_iters_1-1"
                                                       ".json"))
    _, bad = _cfgs(train_kw=dict(metrics=("bleu",)))
    with pytest.raises(ValueError, match="unknown metrics"):
        tdriver.pretrain(bad, ds, valid_dataset=ds, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(parallel=TPar(tensor_parallel=2)),
    dict(parallel=TPar(pipeline_parallel=2)),
    dict(parallel=TPar(data_parallel=2)),
    dict(parallel=TPar(context_parallel=2)),
    dict(model=ttiny(fused_lm_head=True)),
])
def test_runtime_config_refuses_what_is_not_ported(kw):
    """Data, tensor, pipeline and context parallelism are ported: their
    configs validate (``tests/test_torch_parallel*.py``,
    ``test_torch_pipeline*.py`` and ``test_torch_ring_attention.py``
    train them against JAX's sharded steps), and so is pipeline with
    context parallelism, which JAX runs inside its pipeline
    (``tests/test_torch_pipeline_cp.py``).  The fused LM head is ported:
    its config
    validates and one fused step matches JAX's fused step
    (``tests/test_torch_fused_head.py`` goes further)."""
    if "model" in kw:
        assert TRun(**kw).validate().model.fused_lm_head
        _, _, out = _run_both(dict(fused_lm_head=True), steps=1, accum=1)
        assert out[0][0] == pytest.approx(out[0][1], rel=1e-5, abs=1e-5)
        return
    par = kw["parallel"]
    cfg = TRun(train=TTrain(global_batch_size=8), **kw).validate()
    assert cfg.parallel.world_size == 2
    assert (cfg.model.context_parallel_axis == "cp") == \
        (par.context_parallel > 1)
    both = dataclasses.replace(par, pipeline_parallel=2, context_parallel=2)
    cfg = TRun(parallel=both, train=TTrain(global_batch_size=8)).validate()
    assert cfg.parallel.world_size == 4 * par.data_parallel * \
        par.tensor_parallel
    assert cfg.model.context_parallel_axis == "cp"


def _finetune_losses(argv, capsys):
    assert tfinetune.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("lm loss:")[1].split("|")[0])
              for line in out.splitlines() if "lm loss:" in line]
    return losses, out


def test_finetune_main_trains_tiny_on_cpu(capsys):
    losses, out = _finetune_losses(
        ["--model", "tiny", "--mock_data", "--train_iters", "3",
         "--device", "cpu", "--log_interval", "1", "--seq_length", "32",
         "--global_batch_size", "4", "--micro_batch_size", "2",
         "--params_dtype", "float32", "--attention_impl", "flash",
         "--eval_iters", "1"], capsys)
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "training finished" in out and "validation loss" in out


def test_finetune_bf16_default_flags_on_cpu(capsys):
    losses, _ = _finetune_losses(
        ["--model", "tiny", "--mock_data", "--train_iters", "2",
         "--device", "cpu", "--log_interval", "1", "--seq_length", "16",
         "--eval_iters", "0"], capsys)
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("argv,match", [
    (["--mock_data", "--num_experts", "4"], "MoE"),
    (["--mock_data", "--lora_rank", "4"], "LoRA"),
    (["--mock_data", "--pp", "2"], "parallel"),
    (["--mock_data", "--quantize_matmuls", "int8"], "int8 training"),
])
def test_finetune_refuses_what_is_not_ported(argv, match, capsys):
    """``--num_experts`` trains a MoE model now (``tests/test_torch_moe.py``
    holds it to JAX), and ``--pp 2`` without a world says how to launch
    one (``torchrun``; ``tests/test_torch_pipeline_train.py`` runs
    ``finetune --pp 2`` in a world of 2).  ``--lora_rank`` and
    ``--quantize_matmuls int8`` train now: from the same seeded base and
    first batch, a fresh adapter (B = 0) logs the full finetune's first
    loss exactly, and int8 matmuls log it within 0.05 (the W8A8 logit
    drift; ``tests/test_torch_lora_train.py`` and
    ``test_torch_int8_train.py`` hold both against JAX)."""
    base = ["--model", "tiny", "--train_iters", "1", "--device", "cpu"]
    if match in ("LoRA", "int8 training"):
        run = base + ["--log_interval", "1", "--seq_length", "32",
                      "--mock_data"]
        losses, _ = _finetune_losses(run, capsys)
        ported, _ = _finetune_losses(run + argv[1:], capsys)
        assert len(ported) == 1 and math.isfinite(ported[0])
        if match == "LoRA":
            assert ported == losses
        else:
            assert abs(ported[0] - losses[0]) < 0.05
        return
    if match == "MoE":
        run = base + ["--log_interval", "1", "--seq_length", "32"] + argv
        moe, out = _finetune_losses(run, capsys)
        assert len(moe) == 1 and math.isfinite(moe[0])
        return
    with pytest.raises(ValueError, match="torchrun"):
        tfinetune.main(base + argv)


def test_timers_wait_and_level():
    timers = Timers(log_level=0)
    t = timers("a")
    t.start(barrier=True)
    t.stop(wait_for={"x": torch.ones(2)})
    assert t.count == 1 and t.elapsed() >= 0.0
    assert timers("b", log_level=1).elapsed() == 0.0   # above the level
    line = timers.log(printer=None)
    assert line.startswith("time (ms)")
