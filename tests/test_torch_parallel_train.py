"""Data parallelism, ZeRO-1, tp = 4 and checkpoints across degrees: the
port in a world of four CPU ranks against the JAX package (mirror of
``tests/parallel/test_tensor_parallel.py``: tp = 4 with and without
sequence parallelism, ``test_zero1_state_equivalence``; and of the
drivers' loss curves).

One world (``tests/torch_world.py``) runs every case of the module:

- Llama's loss and grads at tp = 4, with and without sequence
  parallelism, against JAX unsharded and JAX's own tp = 4 step;
- three steps of ``training.driver.pretrain`` at dp = 2 x tp = 2 with
  ZeRO-1 off and on, against JAX's driver at the same degrees (the
  losses at 1e-5), the ZeRO-1 params and moments against the replicated
  optimizer's (the JAX test's limits);
- dropout 0.1 at dp = 2 x tp = 2 against the port at tp = 1 (same key);
- a checkpoint written at dp = 2 x tp = 2 with ZeRO-1 resumed at tp = 1,
  and one written at tp = 1 resumed at dp = 2 x tp = 2, each continuing
  the uninterrupted run's losses;
- the sharded init, save and load holding one whole leaf at a time.
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
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.training import driver as tdriver

import test_torch_parallel as tp2
import torch_world

torch.set_num_threads(1)

WORLD = 4
SEQ = tp2.SEQ
MODEL = tp2._model_kw(tp2.LLAMA, 2)          # padded for tp = 2 (256)
OPT = dict(lr=1e-2, clip_grad=1.0)
MB, ACCUM, DP = 2, 2, 2
GBS = MB * ACCUM * DP
STEPS = 3


def _train(**kw):
    return dict(dict(train_iters=STEPS, seq_length=SEQ, micro_batch_size=MB,
                     global_batch_size=GBS, log_interval=1), **kw)


def _batches(n=4, seed=11):
    """Global batches ``[accum, micro * dp, s]`` (JAX's layout)."""
    g = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        toks = g.integers(0, MODEL["vocab_size"], (ACCUM, MB * DP, SEQ))
        out[str(i)] = {
            "tokens": toks.astype(np.int64),
            "labels": np.roll(toks, -1, -1).astype(np.int64),
            "loss_mask": (g.random(toks.shape) > 0.1).astype(np.float32)}
    return out


def _provider(batches):
    def provider(consumed, gbs):
        i = consumed // gbs
        while True:
            yield batches[str(i)]
            i += 1
    return provider


def _jparams(seed=1):
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(seed), jtiny(**MODEL), tp=2))


def _pmeta(zero: bool, **train):
    return dict(model=("tiny_config", MODEL),
                parallel=dict(data_parallel=DP, tensor_parallel=2,
                              use_distributed_optimizer=zero),
                optimizer=OPT, train=_train(**train))


def _tp1_cfg(**train):
    return TRun(model=ttiny(**MODEL), optimizer=TOpt(**OPT),
                train=TTrain(**_train(**train))).validate()


def _tp1_losses(cfg, params=None):
    losses = []
    tdriver.pretrain(cfg, params=params, batch_provider=_provider(_batches()),
                     device="cpu",
                     on_step=lambda it, m, s: losses.append(float(m["loss"])))
    return losses


# the anomaly rollback: a save every 3 iterations, the samples of
# iterations 4-5 NaN-poisoned, a rollback after 2 anomalies
POISON = (3 * GBS, 5 * GBS)
ROLLBACK_BATCHES = 10


def _rollback_train(root):
    return dict(train_iters=8, save=str(root), save_interval=3,
                anomaly_rollback_after=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    # the reverse move's checkpoint: two steps at tp = 1, written here
    tp1_root = str(tmp / "from_tp1")
    _tp1_losses(_tp1_cfg(train_iters=4, exit_interval=2, save=tp1_root),
                params_from_jax(_jparams(), device="cpu"))
    jobs, names = [], []
    for sp in (False, True):
        kw = tp2._model_kw(tp2.LLAMA, WORLD)
        jobs.append(("grads_case",
                     {"params": tp2._jparams(tp2.LLAMA, WORLD),
                      "batch": tp2._batch(256)},
                     tp2._meta(tp2.LLAMA, sp, tp=WORLD)))
        names.append(f"tp4_sp{int(sp)}")
    for zero in (False, True):
        jobs.append(("pretrain_case", {"params": _jparams(),
                                       "batches": _batches()},
                     _pmeta(zero)))
        names.append(f"pretrain_zero{int(zero)}")
    jobs.append(("grads_case", {"params": tp2._jparams(tp2.DROPOUT),
                                "batch": tp2._batch(250)},
                 dict(tp2._meta(tp2.DROPOUT, True, seed=7),
                      parallel=dict(data_parallel=2, tensor_parallel=2,
                                    sequence_parallel=True),
                      train=dict(seq_length=SEQ, micro_batch_size=2,
                                 global_batch_size=4))))
    names.append("dropout_dp2_tp2")
    jobs.append(("pretrain_case", {"params": _jparams(),
                                   "batches": _batches()},
                 _pmeta(True, train_iters=4, exit_interval=2,
                        save=str(tmp / "from_dp2tp2"))))
    names.append("save_dp2tp2")
    jobs.append(("pretrain_case", {"batches": _batches()},
                 _pmeta(True, train_iters=4, load=tp1_root)))
    names.append("resume_dp2tp2")
    jobs.append(("pretrain_case", {"params": _jparams(),
                                   "batches": _batches(ROLLBACK_BATCHES)},
                 dict(_pmeta(True, **_rollback_train(tmp / "rollback")),
                      poison=POISON)))
    names.append("rollback_dp2tp2")
    jobs.append(("ckpt_leaves_case", {},
                 dict(_pmeta(True), root=str(tmp / "leaves"))))
    names.append("ckpt_leaves")
    outs = torch_world.run_world(WORLD, tmp, jobs)
    return dict(zip(names, outs), tmp=tmp)


@pytest.mark.parametrize("sp", [False, True])
def test_tp4_loss_and_grads_match_jax(world, sp):
    out = world[f"tp4_sp{int(sp)}"]
    batch = tp2._batch(256)
    for tp in (None, WORLD):
        kw = tp2._model_kw(tp2.LLAMA, WORLD)
        loss, grads = _jax_tp4(kw, sp, batch, tp)
        np.testing.assert_allclose(float(out["loss"]), loss, **tp2.LOSS_TOL)
        tp2._assert_grads(out["grads"], grads, f"tp=4 sp={sp} vs JAX {tp}")


def _jax_tp4(kw, sp, batch, tp):
    from megatron_llm_tpu.models import sharding as jshard
    from megatron_llm_tpu.parallel import mesh as jmesh
    from megatron_llm_tpu.training import step as jstep

    cfg = jtiny(**kw)
    params = jm.init_params(jax.random.key(0), cfg, tp=WORLD)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    par = JPar() if tp is None else JPar(tensor_parallel=tp,
                                         sequence_parallel=sp)
    rt = JRun(model=cfg, parallel=par, optimizer=JOpt(),
              train=JTrain(seq_length=SEQ)).validate()
    fn = jax.jit(jax.value_and_grad(lambda p: jstep.compute_loss(rt, p, jb)))
    if tp is None:
        loss, grads = fn(params)
    else:
        mesh = jmesh.build_mesh(par)
        with jmesh.use_mesh(mesh):
            loss, grads = fn(jshard.shard_params(
                params, jshard.param_specs(cfg, par), mesh))
    return float(loss), jax.tree.map(np.asarray, grads)


def _jax_driver_losses(zero: bool, capsys):
    par = JPar(data_parallel=DP, tensor_parallel=2,
               use_distributed_optimizer=zero)
    jc = JRun(model=jtiny(**MODEL), parallel=par, optimizer=JOpt(**OPT),
              train=JTrain(**_train())).validate()
    params = jm.init_params(jax.random.key(1), jc.model, tp=2)
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in _batches().items()}
    capsys.readouterr()
    jdriver.pretrain(jc, params=params, batch_provider=_provider(batches))
    out = capsys.readouterr().out
    return [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|", out)]


@pytest.mark.parametrize("zero", [False, True])
def test_pretrain_dp2_tp2_matches_jax_driver(world, zero, capsys):
    """Three steps of the port's ``pretrain`` at dp = 2, tp = 2 (two
    microbatches a step, 10 % of the tokens masked) log JAX's driver's
    losses within 1e-5."""
    got = world[f"pretrain_zero{int(zero)}"]["losses"]
    want = _jax_driver_losses(zero, capsys)
    assert len(want) == len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_zero1_state_equivalence(world):
    """ZeRO-1 changes where the optimizer state lives, not the update: the
    params and moments after three steps equal the replicated
    optimizer's (JAX ``test_zero1_state_equivalence``'s limits)."""
    rep, z1 = world["pretrain_zero0"], world["pretrain_zero1"]
    np.testing.assert_allclose(z1["losses"], rep["losses"], rtol=1e-6)
    for name in ("params", "mu", "nu"):
        for k, x in torch_world.flatten(rep[name]).items():
            np.testing.assert_allclose(
                torch_world.flatten(z1[name])[k], x, rtol=1e-4, atol=1e-5,
                err_msg=f"ZeRO-1 {name} mismatch at {k}")


def test_dropout_at_dp2_tp2_equals_tp1(world):
    """Dropout 0.1 at dp = 2 x tp = 2 with sequence parallelism: each rank
    keeps its batch, head and sequence block of the global masks, so the
    loss and grads are the one-device run's with the same key."""
    from megatron_llm_tpu_torch.ops import dropout as tdrop
    from megatron_llm_tpu_torch.training import step as tstep
    from megatron_llm_tpu_torch.utils.tree import tree_map

    out = world["dropout_dp2_tp2"]
    cfg = TRun(model=ttiny(**tp2._model_kw(tp2.DROPOUT)),
               train=TTrain(seq_length=SEQ)).validate()
    params = params_from_jax(tp2._jparams(tp2.DROPOUT), device="cpu")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    batch = {k: torch.from_numpy(v) for k, v in tp2._batch(250).items()}
    loss = tstep.compute_loss(cfg, live, batch, rng=tdrop.key(7))
    loss.backward()
    np.testing.assert_allclose(float(out["loss"]), float(loss.detach()),
                               **tp2.LOSS_TOL)
    tp2._assert_grads(out["grads"], tree_map(lambda p: p.grad.numpy(), live),
                      "dropout dp=2 tp=2 vs tp=1")


def test_checkpoint_moves_between_degrees(world):
    """Four steps at tp = 1 uninterrupted; two at dp = 2 x tp = 2 with
    ZeRO-1 that exit and save, resumed at tp = 1; two at tp = 1 that exit
    and save, resumed at dp = 2 x tp = 2 with ZeRO-1: every run logs the
    uninterrupted losses (1e-5)."""
    straight = _tp1_losses(_tp1_cfg(train_iters=4),
                           params_from_jax(_jparams(), device="cpu"))
    saved = world["save_dp2tp2"]["losses"]
    resumed_tp1 = _tp1_losses(_tp1_cfg(
        train_iters=4, load=str(world["tmp"] / "from_dp2tp2")))
    np.testing.assert_allclose(list(saved) + resumed_tp1, straight,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(world["resume_dp2tp2"]["losses"],
                               straight[2:], rtol=1e-5, atol=1e-5)


def test_anomaly_rollback_under_the_mesh(world, tmp_path):
    """Two poisoned iterations at dp = 2 x tp = 2 with ZeRO-1: the driver
    restores the last checkpoint (every rank its blocks), reads past the
    poisoned window and logs what one device logs on the same weights and
    batches (the rollback itself is held to JAX's in
    ``tests/test_torch_rollback.py``)."""
    from megatron_llm_tpu_torch import metrics as metrics_lib

    got = world["rollback_dp2tp2"]
    metrics_lib.RESILIENCE_EVENTS.reset()
    losses = []
    tdriver.pretrain(
        _tp1_cfg(**_rollback_train(tmp_path / "rollback")),
        params=params_from_jax(_jparams(), device="cpu"),
        batch_provider=torch_world.poisoned_provider(
            list(_batches(ROLLBACK_BATCHES).values()), *POISON),
        device="cpu",
        on_step=lambda it, m, s: losses.append(float(m["loss"])))
    assert int(got["rollbacks"]) == 1
    assert metrics_lib.RESILIENCE_EVENTS.get("rollbacks") == 1
    assert np.isnan(losses).sum() == 2
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=1e-5)


def test_sharded_state_holds_one_whole_leaf_at_a_time(world):
    """At dp = 2 x tp = 2 with ZeRO-1, ``setup_train_state`` draws each
    matrix whole and keeps its block, a save gathers one leaf whole at a
    time and a load reads one whole leaf at a time: no earlier whole is
    alive when the next is made, on any rank, and the loaded blocks equal
    the saved ones bit for bit."""
    out = world["ckpt_leaves"]
    assert list(out["most_alive"]) == [0, 0, 0], out["most_alive"]
    assert all(n > 0 for n in out["made"]), out["made"]
    assert int(out["differ"]) == 0
