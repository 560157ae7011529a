"""The port's checkpoints (``megatron_llm_tpu_torch/checkpointing.py``):
the cases of tests/test_checkpointing.py and
tests/resilience/test_crash_safe_checkpointing.py on the port's format,
a ``config.json`` written by the JAX package read by the port, resume
through the driver bitwise equal to an uninterrupted run, and the resumed
loss curve against the JAX driver's on the same weights and batches."""

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

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
from megatron_llm_tpu_torch.config import OptimizerConfig, RuntimeConfig
from megatron_llm_tpu_torch.config import TrainConfig, tiny_config
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as model_lib
from megatron_llm_tpu_torch.resilience import SimulatedCrash, chaos
from megatron_llm_tpu_torch.training import driver
from megatron_llm_tpu_torch.training.step import init_train_state, \
    make_train_step
from megatron_llm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_chaos():
    """Both packages' chaos controllers and event counters start and end
    disarmed."""
    for c, m in ((chaos(), metrics_lib), (jchaos(), jmetrics)):
        c.reset()
        m.RESILIENCE_EVENTS.reset()
    yield
    for c, m in ((chaos(), metrics_lib), (jchaos(), jmetrics)):
        c.reset()
        m.RESILIENCE_EVENTS.reset()


def _cfg(dtype="float32", **train):
    kw = dict(train_iters=10, micro_batch_size=2, global_batch_size=4,
              seq_length=16)
    kw.update(train)
    return RuntimeConfig(model=tiny_config(params_dtype=dtype),
                         optimizer=OptimizerConfig(lr=1e-3,
                                                   lr_warmup_iters=2),
                         train=TrainConfig(**kw)).validate()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 255, (2, 2, 16))
    return {"tokens": torch.as_tensor(toks),
            "labels": torch.as_tensor(np.roll(toks, -1, -1)),
            "loss_mask": torch.ones(2, 2, 16)}


def _state_tensors(state):
    out = tree_leaves(state.params) + tree_leaves(state.opt.mu)
    for tree in (state.opt.nu, state.opt.master):
        if tree is not None:
            out += tree_leaves(tree)
    return out + list(state.guard)


def _params(cfg, seed=0):
    return model_lib.init_params(cfg.model, seed=seed, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_checkpointing.py
# ---------------------------------------------------------------------------


def test_tracker_roundtrip(tmp_path):
    assert ckpt.read_tracker(tmp_path) is None
    ckpt.write_tracker(tmp_path, 42)
    assert ckpt.read_tracker(tmp_path) == 42
    ckpt.write_tracker(tmp_path, "release")
    assert ckpt.read_tracker(tmp_path) == "release"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_resume_equivalence(tmp_path, dtype):
    """Save at 3, train on to 6; reload at 3 into a fresh template and
    retrain: losses and every tensor of the state bitwise equal."""
    cfg = _cfg(dtype)
    step = make_train_step(cfg, "cpu")
    state = init_train_state(cfg, _params(cfg))
    batch = _batch()
    for _ in range(3):
        state, _ = step(state, batch)
    ckpt.save_checkpoint(str(tmp_path), state, cfg)
    assert ckpt.read_tracker(str(tmp_path)) == 3
    saved = [t.clone() for t in _state_tensors(state)]
    cont, losses = state, []
    for _ in range(3):
        cont, m = step(cont, batch)
        losses.append(float(m["loss"]))

    restored, it = ckpt.load_checkpoint(
        str(tmp_path), init_train_state(cfg, _params(cfg, seed=1)))
    assert it == 3 and restored.iteration == 3 and restored.opt.step == 3
    for a, b in zip(_state_tensors(restored), saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    again = []
    for _ in range(3):
        restored, m = step(restored, batch)
        again.append(float(m["loss"]))
    assert again == losses
    for a, b in zip(_state_tensors(cont), _state_tensors(restored)):
        assert torch.equal(a, b)


def test_config_in_checkpoint(tmp_path):
    cfg = _cfg()
    ckpt.save_checkpoint(str(tmp_path), init_train_state(cfg, _params(cfg)),
                         cfg)
    assert ckpt.load_config_from_checkpoint(str(tmp_path)) == cfg


def test_jax_config_json_loads_into_the_same_fields(tmp_path):
    """A config.json written by the JAX package's RuntimeConfig.to_json
    reads into the port config of the same arguments, and back."""
    kw = dict(train_iters=7, micro_batch_size=2, global_batch_size=8,
              seq_length=32, skip_iters=(3, 5), rampup_batch_size=(2, 2, 8),
              save="ckpt", anomaly_rollback_after=2)
    mkw = dict(rope_scaling_factor=2.0, num_kv_heads=1)
    jc = JRun(model=jtiny(**mkw), optimizer=JOpt(lr=2e-4),
              train=JTrain(**kw)).validate()
    tc = RuntimeConfig(model=tiny_config(**mkw),
                       optimizer=OptimizerConfig(lr=2e-4),
                       train=TrainConfig(**kw)).validate()
    assert RuntimeConfig.from_json(jc.to_json()) == tc
    assert JRun.from_json(tc.to_json()) == jc
    (tmp_path / "iter_0000001").mkdir()
    (tmp_path / "iter_0000001" / "config.json").write_text(jc.to_json())
    ckpt.write_tracker(str(tmp_path), 1)
    assert ckpt.load_config_from_checkpoint(str(tmp_path)) == tc


def test_load_checkpoint_handles_release(tmp_path):
    """Tracker 'release': params restored, the template's fresh optimizer
    kept, and its fp32 master refreshed from the loaded params (so the
    first step updates the imported weights, not the template's)."""
    cfg = _cfg("bfloat16")
    params = _params(cfg)
    ckpt.save_release_params(str(tmp_path), params, cfg)
    template = init_train_state(cfg, _params(cfg, seed=1))
    state, it = ckpt.load_checkpoint(str(tmp_path), template)
    assert it == "release" and state.opt.step == 0 and state.iteration == 0
    for a, b, m, mu in zip(tree_leaves(state.params), tree_leaves(params),
                           tree_leaves(state.opt.master),
                           tree_leaves(state.opt.mu)):
        assert torch.equal(a, b)
        assert m.dtype == torch.float32 and torch.equal(m, b.float())
        assert not mu.any()


def test_meta_roundtrip(tmp_path):
    cfg = _cfg()
    ckpt.save_checkpoint(str(tmp_path), init_train_state(cfg, _params(cfg)),
                         cfg, meta={"consumed_samples": 2**40})
    assert ckpt.load_meta(str(tmp_path))["consumed_samples"] == 2**40


def test_load_params_for_inference(tmp_path):
    """Params alone from a full training checkpoint and from a release,
    onto the requested device, cast to the config's dtype."""
    cfg = _cfg("bfloat16")
    params = _params(cfg, seed=3)
    ckpt.save_checkpoint(str(tmp_path), init_train_state(cfg, params), cfg,
                         iteration=5)
    loaded = ckpt.load_params_for_inference(str(tmp_path), cfg.model,
                                            device="cpu")
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert torch.equal(a, b)
    rel = tmp_path / "rel"
    ckpt.save_release_params(str(rel), params, cfg)
    loaded = ckpt.load_params_for_inference(str(rel), cfg.model,
                                            device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded),
                                                 tree_leaves(params)))
    fp32 = tiny_config(params_dtype="float32")
    cast = ckpt.load_params_for_inference(str(rel), fp32, device="cpu")
    assert all(a.dtype == torch.float32 and torch.equal(a, b.float())
               for a, b in zip(tree_leaves(cast), tree_leaves(params)))


@pytest.mark.parametrize("change,match", [
    (lambda p: p["layers"].pop("input_norm"), "keys"),
    (lambda p: p.__setitem__("extra", torch.zeros(2)), "keys"),
    (lambda p: p["final_norm"].__setitem__("scale", torch.ones(3)), "shape"),
    (lambda p: p["final_norm"].__setitem__(
        "scale", p["final_norm"]["scale"].double()), "float64"),
], ids=["missing", "extra", "shape", "dtype"])
def test_load_is_strict(tmp_path, change, match):
    cfg = _cfg()
    params = _params(cfg)
    ckpt.save_release_params(str(tmp_path), params)
    template = _params(cfg, seed=1)
    change(template)
    with pytest.raises(ValueError, match=match):
        ckpt.load_release_params(str(tmp_path), template)


def test_a_state_with_more_tensors_than_the_template_is_refused(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(2),
                                         "v": torch.ones(3)}, iteration=1)
    with pytest.raises(ValueError, match="keys"):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(2)})


def test_host_scalars_none_and_numpy_leaves(tmp_path):
    """state.json carries the host numbers and None leaves; a numpy leaf
    (no tree of the port holds one) is refused."""
    cfg = _cfg("float16")
    state = init_train_state(cfg, _params(cfg))
    state = state._replace(iteration=7, skipped=2)
    ckpt.save_checkpoint(str(tmp_path), state, cfg)
    back, _ = ckpt.load_checkpoint(
        str(tmp_path), init_train_state(cfg, _params(cfg, seed=1)))
    assert (back.iteration, back.skipped) == (7, 2)
    assert back.opt.scaler == state.opt.scaler
    assert back.opt.scaler.scale == 2.0**32 and back.opt.nu is not None
    tree = {"a": torch.arange(4, dtype=torch.int32), "b": None, "c": 1.5}
    ckpt.save_checkpoint(str(tmp_path / "tree"), tree, iteration=1)
    got, _ = ckpt.load_checkpoint(str(tmp_path / "tree"),
                                  {"a": torch.zeros(4, dtype=torch.int32),
                                   "b": None, "c": 0.0})
    assert torch.equal(got["a"], tree["a"]) and got["b"] is None
    assert got["c"] == 1.5
    with pytest.raises(TypeError, match="ndarray"):
        ckpt.save_checkpoint(str(tmp_path / "np"),
                             {"a": np.arange(4, dtype=np.int32)},
                             iteration=1)


# ---------------------------------------------------------------------------
# tests/resilience/test_crash_safe_checkpointing.py
# ---------------------------------------------------------------------------


def _state(v: float):
    return {"w": torch.full((8,), float(v)),
            "step": torch.tensor(int(v), dtype=torch.int32)}


def _template():
    return {"w": torch.zeros(8), "step": torch.zeros((), dtype=torch.int32)}


def _assert_loads(root, expect_iter, expect_value):
    state, it = ckpt.load_checkpoint(str(root), _template())
    assert it == expect_iter
    assert torch.equal(state["w"], torch.full((8,), float(expect_value)))
    assert int(state["step"]) == expect_value


@pytest.mark.chaos
def test_tracker_write_is_atomic(tmp_path):
    ckpt.write_tracker(str(tmp_path), 1)
    chaos().crash_at("tracker-replace")
    with pytest.raises(SimulatedCrash):
        ckpt.write_tracker(str(tmp_path), 2)
    assert ckpt.read_tracker(str(tmp_path)) == 1
    ckpt.write_tracker(str(tmp_path), 2)
    assert ckpt.read_tracker(str(tmp_path)) == 2


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["ckpt-begin", "ckpt-staging",
                                  "ckpt-pre-commit", "ckpt-pre-tracker"])
def test_crash_mid_save_leaves_previous_checkpoint(tmp_path, site):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), iteration=1)
    chaos().crash_at(site)
    with pytest.raises(SimulatedCrash):
        ckpt.save_checkpoint(root, _state(2), iteration=2)
    assert ckpt.read_tracker(root) == 1
    # payload then tracker: an unmoved tracker is honoured even when the
    # new payload landed
    assert ckpt.is_complete(root, 2) == (site == "ckpt-pre-tracker")
    _assert_loads(root, 1, 1)
    ckpt.save_checkpoint(root, _state(2), iteration=2)
    assert ckpt.read_tracker(root) == 2
    _assert_loads(root, 2, 2)
    assert not list(tmp_path.glob("iter_*" + ckpt.STAGING_SUFFIX))


_KILL_SCRIPT = textwrap.dedent("""
    import torch
    from megatron_llm_tpu_torch import checkpointing as ckpt
    from megatron_llm_tpu_torch.resilience import chaos

    root = {root!r}

    def state(v):
        return {{"w": torch.full((8,), float(v)),
                 "step": torch.tensor(v, dtype=torch.int32)}}

    ckpt.save_checkpoint(root, state(1), iteration=1,
                         meta={{"consumed_samples": 100}})
    chaos().kill_at("ckpt-pre-commit")
    ckpt.save_checkpoint(root, state(2), iteration=2,
                         meta={{"consumed_samples": 200}})
    raise SystemExit("unreachable: the save above must SIGKILL us")
""")


@pytest.mark.chaos
def test_real_sigkill_mid_save_resumes_from_previous(tmp_path):
    """A process SIGKILLed mid-save (payload written, commit not made)
    leaves a root that loads the previous checkpoint with its
    consumed_samples."""
    root = str(tmp_path / "ckpt")
    proc = subprocess.run([sys.executable, "-c",
                           _KILL_SCRIPT.format(root=root)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert ckpt.read_tracker(root) == 1
    assert not ckpt.is_complete(root, 2)
    assert list(Path(root).glob("iter_*" + ckpt.STAGING_SUFFIX))
    _assert_loads(root, 1, 1)
    assert ckpt.load_meta(root)["consumed_samples"] == 100
    ckpt.save_checkpoint(root, _state(2), iteration=2,
                         meta={"consumed_samples": 200})
    _assert_loads(root, 2, 2)
    assert ckpt.load_meta(root)["consumed_samples"] == 200


@pytest.mark.chaos
def test_io_failure_is_retried(tmp_path):
    root = str(tmp_path)
    chaos().fail_io("ckpt-state-save", times=2)
    ckpt.save_checkpoint(root, _state(1), iteration=1, retries=3)
    _assert_loads(root, 1, 1)
    assert metrics_lib.RESILIENCE_EVENTS.get("io_retries") == 2
    assert metrics_lib.RESILIENCE_EVENTS.get("io_giveups") == 0


@pytest.mark.chaos
def test_io_failure_beyond_retries_fails_clean(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), iteration=1)
    chaos().fail_io("ckpt-state-save", times=10)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(root, _state(2), iteration=2, retries=3)
    assert metrics_lib.RESILIENCE_EVENTS.get("io_giveups") == 1
    assert ckpt.read_tracker(root) == 1
    assert not list(tmp_path.glob("iter_*" + ckpt.STAGING_SUFFIX))
    _assert_loads(root, 1, 1)


@pytest.mark.chaos
def test_restore_io_failure_is_retried(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(3), iteration=3)
    chaos().fail_io("ckpt-restore", times=1)
    _assert_loads(root, 3, 3)
    assert metrics_lib.RESILIENCE_EVENTS.get("io_retries") == 1


@pytest.mark.chaos
def test_gc_retention_keeps_newest(tmp_path):
    root = str(tmp_path)
    for it in range(1, 6):
        ckpt.save_checkpoint(root, _state(it), iteration=it, keep=2)
    assert ckpt.list_iterations(root) == [4, 5]
    assert metrics_lib.RESILIENCE_EVENTS.get("checkpoint_gc_deleted") == 3
    assert metrics_lib.RESILIENCE_EVENTS.get("checkpoint_saves") == 5
    _assert_loads(root, 5, 5)


@pytest.mark.chaos
def test_torn_tracker_falls_back_to_scan(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), iteration=1)
    ckpt.save_checkpoint(root, _state(2), iteration=2)
    (tmp_path / ckpt.TRACKER_FILENAME).write_text("garb\x00age")
    _assert_loads(root, 2, 2)
    assert metrics_lib.RESILIENCE_EVENTS.get("checkpoint_fallbacks") == 1


@pytest.mark.chaos
def test_tracker_ahead_of_torn_payload_falls_back(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), iteration=1)
    (tmp_path / "iter_0000002" / "state").mkdir(parents=True)
    ckpt.write_tracker(root, 2)
    _assert_loads(root, 1, 1)
    assert metrics_lib.RESILIENCE_EVENTS.get("checkpoint_fallbacks") == 1
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(root, _template(), iteration=2)


@pytest.mark.chaos
def test_a_payload_without_its_marker_is_incomplete(tmp_path):
    """Every file but the marker: not a checkpoint."""
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), iteration=1)
    ckpt.save_checkpoint(root, _state(2), iteration=2)
    os.remove(tmp_path / "iter_0000002" / "state" / ckpt.COMMIT_MARKER)
    assert not ckpt.is_complete(root, 2)
    assert ckpt.latest_complete_iteration(root) == 1
    _assert_loads(root, 1, 1)


@pytest.mark.chaos
def test_save_checkpoint_writes_config_and_meta_json(tmp_path):
    cfg = _cfg()
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _state(1), cfg, iteration=1,
                         meta={"consumed_samples": 7})
    committed = tmp_path / "iter_0000001"
    assert json.loads((committed / "meta.json").read_text()) == {
        "consumed_samples": 7}
    assert RuntimeConfig.from_json(
        (committed / "config.json").read_text()) == cfg
    assert sorted(os.listdir(committed / "state")) == [
        ckpt.COMMIT_MARKER, "model.safetensors", ckpt.STATE_JSON]


# ---------------------------------------------------------------------------
# Resume through the driver
# ---------------------------------------------------------------------------

SEQ, GBS = 16, 4


def _provider(vocab):
    """A batch provider whose batch follows the data position."""
    def provider(consumed, gbs):
        pos = consumed
        while True:
            rng = np.random.default_rng(1000 + pos)
            toks = rng.integers(0, vocab, (2, 2, SEQ))
            yield {"tokens": toks.astype(np.int32),
                   "labels": np.roll(toks, -1, -1).astype(np.int32),
                   "loss_mask": np.ones((2, 2, SEQ), np.float32)}
            pos += gbs
    return provider


def _drv_cfgs(**train):
    mkw = dict(num_layers=1, hidden_size=32, num_attention_heads=2,
               num_kv_heads=2, ffn_hidden_size=64, vocab_size=128,
               seq_length=SEQ, max_position_embeddings=SEQ)
    tkw = dict(train_iters=6, micro_batch_size=2, global_batch_size=GBS,
               seq_length=SEQ, log_interval=1)
    tkw.update(train)
    okw = dict(lr=1e-3, lr_warmup_iters=2)
    return (JRun(model=jtiny(**mkw), optimizer=JOpt(**okw),
                 train=JTrain(**tkw)).validate(),
            RuntimeConfig(model=tiny_config(**mkw),
                          optimizer=OptimizerConfig(**okw),
                          train=TrainConfig(**tkw)).validate())


def _losses(out: str):
    return [float(line.split("lm loss:")[1].split("|")[0])
            for line in out.splitlines() if "lm loss:" in line]


def test_driver_resume_equals_uninterrupted_bitwise(tmp_path):
    """Six iterations straight, against three that exit and save, then a
    resume to six: the same losses and the same params, bit for bit."""
    _, tc = _drv_cfgs()
    provider = _provider(tc.model.vocab_size)
    params = model_lib.init_params(tc.model, seed=4, device="cpu")

    def run(cfg, p=None):
        seen = []
        state = driver.pretrain(cfg, params=p, batch_provider=provider,
                                device="cpu", on_step=lambda it, m, s:
                                seen.append((it, float(m["loss"]))))
        return state, seen

    straight, s_losses = run(tc, {k: v for k, v in params.items()})
    root = str(tmp_path / "ckpt")
    _, first = run(_drv_cfgs(exit_interval=3, save=root)[1],
                   model_lib.init_params(tc.model, seed=4, device="cpu"))
    assert ckpt.read_tracker(root) == 3
    assert ckpt.load_meta(root)["consumed_samples"] == 3 * GBS
    resumed, second = run(_drv_cfgs(load=root)[1])
    assert first + second == s_losses
    assert resumed.iteration == 6 and resumed.opt.step == 6
    for a, b in zip(_state_tensors(resumed), _state_tensors(straight)):
        assert torch.equal(a, b)


def test_driver_resume_curve_matches_jax(tmp_path, capsys):
    """The same weights (the JAX package's, carried across) and batches
    through both drivers, each saving at 3 and resuming to 6: the resumed
    losses agree within 1e-5."""
    jc, tc = _drv_cfgs()
    jparams = jmodel.init_params(jax.random.key(2), jc.model)
    # carried across first: the JAX driver donates its params' buffers
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    provider = _provider(tc.model.vocab_size)
    curves = {}
    for name, (cfgs, run) in {
        "jax": (lambda **kw: _drv_cfgs(**kw)[0],
                lambda c, p: jdriver.pretrain(c, params=p,
                                              batch_provider=provider)),
        "port": (lambda **kw: _drv_cfgs(**kw)[1],
                 lambda c, p: driver.pretrain(c, params=p,
                                              batch_provider=provider,
                                              device="cpu")),
    }.items():
        root = str(tmp_path / name)
        p = jparams if name == "jax" else tparams
        capsys.readouterr()
        run(cfgs(exit_interval=3, save=root), p)
        run(cfgs(load=root), None)
        out = capsys.readouterr().out
        assert "loaded checkpoint" in out and "at iteration 3" in out
        curves[name] = _losses(out)
    assert len(curves["port"]) == len(curves["jax"]) == 6
    np.testing.assert_allclose(curves["port"], curves["jax"], atol=1e-5,
                               rtol=0)
