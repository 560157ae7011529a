"""The port's eval metrics registry and scalar writers against the JAX
package's, on the CPU.

``compute_metrics`` gets the same logits, per-token losses and batch on
both sides (fp32); each metric must agree to 1e-6 relative (the masked
means sum a few hundred fp32 terms in different orders).
"""

import io
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import metrics as jmetrics
from megatron_llm_tpu.utils import writers as jwriters
from megatron_llm_tpu_torch import metrics as tmetrics
from megatron_llm_tpu_torch.utils import writers as twriters
from megatron_llm_tpu_torch.utils.timers import Timers

ALL = sorted(jmetrics.METRICS)


def _inputs(seed, assistant, vocab=50, b=3, s=16):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, s, vocab)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    # make some predictions right
    hit = rng.random((b, s)) < 0.3
    labels[hit] = logits.argmax(-1)[hit]
    loss_mask = rng.choice([0.0, 0.2, 1.0], (b, s)).astype(np.float32)
    per_token = rng.random((b, s)).astype(np.float32) * 4
    batch = {"tokens": labels, "labels": labels, "loss_mask": loss_mask}
    if assistant:
        batch["assistant_mask"] = (rng.random((b, s)) < 0.5).astype(
            np.float32)
    return batch, logits, per_token


@pytest.mark.parametrize("assistant", [False, True])
@pytest.mark.parametrize("names", [ALL, ["perplexity"], ["accuracy",
                                                         "count_loss_mask"],
                                   ["instruct_accuracy",
                                    "count_instruct_mask"]])
def test_compute_metrics_matches_jax(names, assistant):
    batch, logits, per_token = _inputs(len(names), assistant)
    want = jmetrics.compute_metrics(
        names, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(logits), jnp.asarray(per_token))
    got = tmetrics.compute_metrics(
        names, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(logits), torch.from_numpy(per_token))
    assert list(got) == list(want) == list(names)
    for n in names:
        assert got[n].shape == ()
        assert float(got[n]) == pytest.approx(float(want[n]), rel=1e-6,
                                              abs=1e-7), n


def test_correctness_without_logits_matches_jax():
    """The pipelined eval's form: ``correct`` given, no logits; metrics
    that need the predictions raise alike."""
    batch, logits, per_token = _inputs(9, True)
    correct = (logits.argmax(-1) == batch["labels"]).astype(np.float32)
    names = ["accuracy", "instruct_accuracy", "perplexity"]
    want = jmetrics.compute_metrics(
        names, {k: jnp.asarray(v) for k, v in batch.items()}, None,
        jnp.asarray(per_token), correct=jnp.asarray(correct))
    got = tmetrics.compute_metrics(
        names, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
        torch.from_numpy(per_token), correct=torch.from_numpy(correct))
    for n in names:
        assert float(got[n]) == pytest.approx(float(want[n]), rel=1e-6)
    inp = tmetrics.MetricInput(batch, None, torch.from_numpy(per_token))
    with pytest.raises(ValueError, match="without logits"):
        inp.predictions
    jinp = jmetrics.MetricInput(batch, None, jnp.asarray(per_token))
    with pytest.raises(ValueError, match="without logits"):
        jinp.predictions


@pytest.mark.parametrize("names", [["perplexity", "bleu"], ["nope"],
                                   ["Accuracy"]])
def test_unknown_names_refused_alike(names):
    with pytest.raises(ValueError) as want:
        jmetrics.validate_metric_names(names)
    with pytest.raises(ValueError) as got:
        tmetrics.validate_metric_names(names)
    assert str(got.value) == str(want.value)
    tmetrics.validate_metric_names(ALL)
    assert sorted(tmetrics.METRICS) == ALL


def test_event_counters_kept():
    c = tmetrics.EventCounters()
    c.inc("saves")
    c.inc("saves", 2)
    assert c.get("saves") == 3 and c.snapshot() == {"saves": 3}
    c.reset()
    assert c.snapshot() == {}


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


def _build(mod, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        w = mod.build_writer(**kw)
    return w, out.getvalue()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wandb_project="proj"),
    dict(tensorboard_dir="TB"),
    dict(wandb_project="proj", tensorboard_dir="TB"),
])
def test_build_writer_precedence_and_warnings_match_jax(kw, tmp_path,
                                                        monkeypatch):
    """wandb wins when both are set; a missing package prints JAX's
    warning and falls through (to TensorBoard, else the NullWriter)."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    if "tensorboard_dir" in kw:
        kw = dict(kw, tensorboard_dir=str(tmp_path / "tb"))
    tw, tout = _build(twriters, **kw)
    if "tensorboard_dir" in kw:
        kw = dict(kw, tensorboard_dir=str(tmp_path / "jtb"))
    jw, jout = _build(jwriters, **kw)
    assert type(tw).__name__ == type(jw).__name__
    assert tout == jout
    for w in (tw, jw):
        w.add_scalar("train/lm_loss", 1.5, 1)
        w.flush()
        w.close()
    if "tensorboard_dir" in kw:
        assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_wandb_shim_logs_through_wandb(monkeypatch):
    logged = []

    class Run:
        def finish(self):
            logged.append("finish")

    fake = type(sys)("wandb")
    fake.init = lambda **kw: (logged.append(("init", kw["project"])), Run())[1]
    fake.log = lambda d, step: logged.append((d, step))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    w = twriters.build_writer(wandb_project="proj", tensorboard_dir="x")
    assert isinstance(w, twriters.WandbTBShim)
    w.add_scalar("valid/perplexity", 3.0, 7)
    w.add_text("note", "hi", 7)
    w.close()
    assert logged == [("init", "proj"), ({"valid/perplexity": 3.0}, 7),
                      ({"note": "hi"}, 7), "finish"]


def test_timers_write_like_jax():
    from megatron_llm_tpu.utils.timers import Timers as JTimers

    rows = {}
    for k, timers in enumerate((Timers(), JTimers())):
        timers("step").start()
        timers("step").stop()
        timers("step").start()
        timers("step").stop()
        out = []

        class W:
            def add_scalar(self, tag, value, step):
                out.append((tag, step))

        timers.write(W(), 5)
        rows[k] = out
    assert rows[0] == rows[1] == [("timers/step", 5)]
