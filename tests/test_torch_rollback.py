"""Rollback after K anomalies on the port's driver (the cases of
tests/resilience/test_rollback.py), held against the JAX driver on the
same weights and batches: the same iterations are restored and the losses
agree within 1e-5.

A poisoned stretch of the corpus NaNs every loss for longer than per-step
skips should absorb.  After K consecutive data anomalies the driver
restores the last complete checkpoint but keeps consumed_samples where it
is, so the replayed iterations read past the poisoned window."""

import re

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu import metrics as jmetrics
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.resilience import chaos as jchaos
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch import checkpointing as ckpt
from megatron_llm_tpu_torch import metrics as metrics_lib
from megatron_llm_tpu_torch.config import (
    OptimizerConfig,
    RuntimeConfig,
    TrainConfig,
    tiny_config,
)
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.resilience import chaos, poison_nan
from megatron_llm_tpu_torch.training.driver import (
    pretrain,
    rollback_to_last_checkpoint,
)
from megatron_llm_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)

SEQ = 16
GBS = 4  # accum 2 x micro 2


@pytest.fixture(autouse=True)
def clean_chaos():
    for c, m in ((chaos(), metrics_lib), (jchaos(), jmetrics)):
        c.reset()
        m.RESILIENCE_EVENTS.reset()
    yield
    for c, m in ((chaos(), metrics_lib), (jchaos(), jmetrics)):
        c.reset()
        m.RESILIENCE_EVENTS.reset()


_MODEL = dict(num_layers=1, hidden_size=32, num_attention_heads=2,
              num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
              seq_length=SEQ, max_position_embeddings=SEQ)


def _train(tmp_path, **over):
    train = dict(train_iters=8, micro_batch_size=2, global_batch_size=GBS,
                 seq_length=SEQ, save=str(tmp_path / "ckpt"),
                 save_interval=3, log_interval=1)
    train.update(over)
    return train


def _cfg(tmp_path, **over):
    return RuntimeConfig(model=tiny_config(**_MODEL),
                         optimizer=OptimizerConfig(lr=1e-3,
                                                   lr_warmup_iters=2),
                         train=TrainConfig(**_train(tmp_path, **over))
                         ).validate()


def _jcfg(tmp_path, **over):
    return JRun(model=jtiny(**_MODEL),
                optimizer=JOpt(lr=1e-3, lr_warmup_iters=2),
                train=JTrain(**_train(tmp_path, **over))).validate()


def _sample_batch(pos, vocab):
    rng = np.random.default_rng(1000 + pos)
    toks = rng.integers(0, vocab, (2, 2, SEQ))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, -1).astype(np.int32),
            "loss_mask": np.ones((2, 2, SEQ), np.float32)}


def _poisoned_provider(vocab, lo, hi):
    """Samples in [lo, hi) NaN-poisoned: the poison follows the data
    position, as a bad corpus shard does."""
    def provider(consumed, gbs):
        assert gbs == GBS
        pos = consumed
        while True:
            batch = _sample_batch(pos, vocab)
            if pos < hi and pos + gbs > lo:
                batch = poison_nan(batch)
            pos += gbs
            yield batch
    return provider


def _finite(state):
    return all(torch.isfinite(t).all() for t in tree_leaves(state.params))


def test_rollback_after_k_anomalies_skips_poisoned_window(tmp_path):
    """save@3 (consumed 12), iterations 4-5 poisoned (samples 12..20);
    after K=2 anomalies the driver restores 3 and resumes on samples
    20.., reaching train_iters with finite params."""
    cfg = _cfg(tmp_path, anomaly_rollback_after=2)
    state = pretrain(cfg, batch_provider=_poisoned_provider(
        cfg.model.vocab_size, 12, 20), device="cpu")
    assert state.iteration == 8
    assert metrics_lib.RESILIENCE_EVENTS.get("rollbacks") == 1
    assert ckpt.load_meta(cfg.train.save)["consumed_samples"] == 10 * GBS
    assert _finite(state)
    assert state.skipped == 0


def _log(out):
    """(restored iterations, losses) from a driver's stdout."""
    restored = [int(m) for m in re.findall(r"restored iteration (\d+)", out)]
    losses = [float(line.split("lm loss:")[1].split("|")[0])
              for line in out.splitlines() if "lm loss:" in line]
    return restored, losses


@pytest.mark.parametrize("k,lo,hi", [(2, 12, 20), (1, 16, 20),
                                     (2, 4, 12)],
                         ids=["k2-iters4-5", "k1-iter5", "k2-iters2-3"])
def test_rollback_matches_the_jax_driver(tmp_path, capsys, k, lo, hi):
    """The same weights and poisoned batches through both drivers: the
    same iterations restored, the same count of rollbacks, and losses
    within 1e-5."""
    jc = _jcfg(tmp_path / "jax", anomaly_rollback_after=k)
    tc = _cfg(tmp_path / "port", anomaly_rollback_after=k)
    jparams = jmodel.init_params(jax.random.key(3), jc.model)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    capsys.readouterr()
    jstate = jdriver.pretrain(jc, params=jparams, batch_provider=(
        _poisoned_provider(128, lo, hi)))
    jrestored, jlosses = _log(capsys.readouterr().out)
    tstate = pretrain(tc, params=tparams, batch_provider=(
        _poisoned_provider(128, lo, hi)), device="cpu")
    trestored, tlosses = _log(capsys.readouterr().out)
    assert jrestored and trestored == jrestored
    assert (metrics_lib.RESILIENCE_EVENTS.get("rollbacks")
            == jmetrics.RESILIENCE_EVENTS.get("rollbacks") == len(jrestored))
    assert tstate.iteration == int(jstate.iteration) == 8
    assert (ckpt.load_meta(tc.train.save)["consumed_samples"]
            == jdriver.checkpointing.load_meta(jc.train.save)[
                "consumed_samples"])
    assert len(tlosses) == len(jlosses)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)


def test_rollback_writes_anchor_checkpoint_when_none_exists(tmp_path):
    cfg = _cfg(tmp_path, train_iters=1, save_interval=100,
               anomaly_rollback_after=2)
    assert ckpt.latest_complete_iteration(cfg.train.save) is None
    pretrain(cfg, batch_provider=_poisoned_provider(128, -1, -1),
             device="cpu")
    assert ckpt.is_complete(cfg.train.save, 0)


def test_rollback_restores_checkpoint_bitwise(tmp_path):
    cfg = _cfg(tmp_path)
    root = cfg.train.save
    saved = {"w": torch.arange(16, dtype=torch.float32),
             "step": torch.tensor(5, dtype=torch.int32)}
    ckpt.save_checkpoint(root, saved, iteration=5)
    diverged = {"w": torch.full((16,), float("nan")),
                "step": torch.tensor(9, dtype=torch.int32)}
    restored, it = rollback_to_last_checkpoint(cfg, diverged)
    assert it == 5
    assert torch.equal(restored["w"], saved["w"])
    assert metrics_lib.RESILIENCE_EVENTS.get("rollbacks") == 1


def test_rollback_gives_up_after_max_rollbacks(tmp_path):
    cfg = _cfg(tmp_path, anomaly_max_rollbacks=2)
    ckpt.save_checkpoint(cfg.train.save, {"w": torch.zeros(4)}, iteration=1)
    with pytest.raises(RuntimeError, match="giving up"):
        rollback_to_last_checkpoint(cfg, {"w": torch.ones(4)}, attempt=3)


def test_rollback_without_checkpoint_root_fails_loudly(tmp_path):
    cfg = _cfg(tmp_path, save=None)
    with pytest.raises(RuntimeError, match="checkpoint root"):
        rollback_to_last_checkpoint(cfg, {"w": torch.ones(4)})


def test_driver_resumes_past_torn_checkpoint(tmp_path):
    """The tracker points at a torn iteration: resume falls back to the
    newest complete checkpoint and finishes training."""
    cfg = _cfg(tmp_path, train_iters=2, save_interval=2)
    provider = _poisoned_provider(128, -1, -1)
    pretrain(cfg, batch_provider=provider, device="cpu")
    assert ckpt.read_tracker(cfg.train.save) == 2
    (tmp_path / "ckpt" / "iter_0000003" / "state").mkdir(parents=True)
    ckpt.write_tracker(cfg.train.save, 3)
    cfg2 = _cfg(tmp_path, train_iters=4, save_interval=100,
                load=str(tmp_path / "ckpt"))
    state = pretrain(cfg2, batch_provider=provider, device="cpu")
    assert metrics_lib.RESILIENCE_EVENTS.get("checkpoint_fallbacks") >= 1
    assert state.iteration == 4
    assert ckpt.load_meta(cfg2.train.save)["consumed_samples"] == 4 * GBS


def test_driver_refuses_a_checkpoint_that_fails_part_way(tmp_path):
    """A resume whose payload loses a file after the target was chosen
    raises: the template's tensors may hold part of the checkpoint, so
    training must not go on from them.  With no checkpoint at all the
    driver starts from scratch."""
    cfg = _cfg(tmp_path, train_iters=2, save_interval=2)
    provider = _poisoned_provider(128, -1, -1)
    pretrain(cfg, batch_provider=provider, device="cpu")
    payload = tmp_path / "ckpt" / "iter_0000002" / "state"
    for f in payload.glob("*.safetensors"):
        f.unlink()
    cfg2 = _cfg(tmp_path, train_iters=4, save_interval=100,
                load=str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        pretrain(cfg2, batch_provider=provider, device="cpu")
    cfg3 = _cfg(tmp_path, train_iters=1, save=None,
                load=str(tmp_path / "empty"))
    state = pretrain(cfg3, batch_provider=provider, device="cpu")
    assert state.iteration == 1


def test_chaos_poison_keyed_to_iterations_gives_up(tmp_path):
    """``chaos().poison_batches`` reaches the port's driver.  Its poison
    follows the iteration number, so every replay of 4-5 is poisoned
    again: the driver rolls back ``anomaly_max_rollbacks`` times and then
    gives up instead of thrashing."""
    cfg = _cfg(tmp_path, anomaly_rollback_after=2, anomaly_max_rollbacks=2)
    chaos().poison_batches([4, 5])
    with pytest.raises(RuntimeError, match="giving up"):
        pretrain(cfg, batch_provider=_poisoned_provider(128, -1, -1),
                 device="cpu")
    assert metrics_lib.RESILIENCE_EVENTS.get("rollbacks") == 2
    assert ("poison", "iter-4") in chaos().events
