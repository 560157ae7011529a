"""Training orchestration: the ``pretrain()`` driver on one device (mirror
of ``megatron_llm_tpu/training/driver.py``; reference
megatron/training.py:55-961).

- ``setup_train_state``: params (given, or drawn from the seed) and a fresh
  optimizer state on the device, plus the train step.
- ``pretrain``: the loop: resume from ``train.load`` (``consumed_samples``
  from the checkpoint's meta), data iterator, ``skip_iters``, batch-size
  ramp, ``training_log`` (tokens/s and model TFLOP/s), eval hooks, saves
  at ``save_interval`` and at the end or on exit, anomaly rollback to the
  last complete checkpoint, exit conditions and the SIGTERM handler.
- ``make_eval_step`` / ``evaluate``: the forward-only LM loss.
- ``rollback_to_last_checkpoint``: the rollback's restore.

Refused with ``NotImplementedError``, naming the ROADMAP item (Queue 1
item 7: training I/O): the metrics registry (``train.metrics``), the
profiler window (``profile_dir``), and TensorBoard / wandb export.
"""

from __future__ import annotations

import datetime
import signal
import sys
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .. import checkpointing
from .. import metrics as metrics_lib
from ..config import RuntimeConfig
from ..data.samplers import BatchIterator
from ..models import model as model_lib
from ..models.transformer import rope_tables
from ..ops import dropout as drop
from ..parallel.cross_entropy import cross_entropy, masked_mean_loss
from ..resilience import chaos
from ..utils.timers import Timers
from ..utils.writers import build_writer
from .microbatches import build_num_microbatches_calculator
from .step import TrainState, init_train_state, make_train_step, \
    to_device_batch

PyTree = Any
_TRAINING_IO = "(ROADMAP.md, Queue 1 item 7: training I/O)"


def print_rank_0(*args, **kwargs):
    """One process: it always speaks."""
    print(*args, **kwargs, flush=True)


def _refuse_unported(cfg: RuntimeConfig) -> None:
    t = cfg.train
    if t.metrics:
        raise NotImplementedError(
            f"the eval metrics registry ({list(t.metrics)}) is not ported "
            f"yet {_TRAINING_IO}")
    if t.profile_dir:
        raise NotImplementedError(
            f"the profiler window (profile_dir) is not ported yet "
            f"{_TRAINING_IO}")


class DistSignalHandler:
    """Capture a signal for a clean exit at the end of the current
    iteration (reference: megatron/dist_signal_handler.py:50-81)."""

    def __init__(self, sig: int = signal.SIGTERM):
        self.sig = sig
        self._received = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self._received = True

        self._prev = signal.signal(self.sig, handler)
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(self.sig, self._prev)
        return False

    def signals_received(self) -> bool:
        return self._received


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


class TrainingArtifacts:
    """What ``pretrain`` needs per run: state, step and device."""

    def __init__(self, cfg, state, step_fn, device):
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.device = device


def setup_train_state(cfg: RuntimeConfig, params: Optional[PyTree] = None,
                      device=None) -> TrainingArtifacts:
    """Params (``params``, or ``init_params`` from ``cfg.train.seed``) and a
    fresh optimizer state on ``device`` (default ``cuda``), and the step."""
    device = model_lib.default_device(device)
    if params is None:
        params = model_lib.init_params(cfg.model, seed=cfg.train.seed,
                                       device=device)
    state = init_train_state(cfg, params)
    return TrainingArtifacts(cfg, state, make_train_step(cfg, device),
                             device)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def make_eval_step(cfg: RuntimeConfig, metric_names=(), device=None):
    """Forward-only ``eval_step(params, batch) -> {"lm_loss": float}``."""
    if metric_names:
        raise NotImplementedError(
            f"the eval metrics registry ({list(metric_names)}) is not "
            f"ported yet {_TRAINING_IO}")
    rope = rope_tables(cfg.model, device=model_lib.default_device(device))

    @torch.no_grad()
    def eval_step(params, batch):
        logits = model_lib.forward(
            cfg.model, params, batch["tokens"],
            position_ids=batch.get("position_ids"),
            segment_ids=batch.get("segment_ids"), rope=rope)
        per_token = cross_entropy(logits, batch["labels"],
                                  vocab_size=cfg.model.vocab_size)
        return {"lm_loss": masked_mean_loss(per_token, batch["loss_mask"])}

    return eval_step


def evaluate(cfg: RuntimeConfig, params, data_iterator, eval_step,
             device, eval_iters: Optional[int] = None) -> dict[str, float]:
    """Average eval metrics over ``eval_iters`` batches, each
    ``[accum, micro, ...]`` flattened to ``[accum * micro, ...]``."""
    if eval_iters is None:
        eval_iters = cfg.train.eval_iters
    totals: dict[str, float] = {}
    n = 0
    for _ in range(eval_iters):
        try:
            batch = next(data_iterator)
        except StopIteration:
            break
        flat = {k: np.reshape(v, (-1,) + v.shape[2:])
                for k, v in batch.items()}
        out = eval_step(params, to_device_batch(flat, device))
        for k, v in out.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in totals.items()}


def evaluate_and_print_results(prefix: str, cfg, params, data_iterator,
                               eval_step, device, writer=None,
                               iteration: int = 0) -> dict[str, float]:
    results = evaluate(cfg, params, data_iterator, eval_step, device)
    string = f" validation loss at {prefix} | "
    for k, v in results.items():
        string += f"{k}: {v:.6E} | "
        if writer is not None:
            writer.add_scalar(f"valid/{k}", v, iteration)
        if k == "lm_loss":
            string += f"lm loss PPL: {float(np.exp(min(20.0, v))):.6E} | "
    print_rank_0("-" * (len(string) + 1))
    print_rank_0(string)
    print_rank_0("-" * (len(string) + 1))
    return results


# ---------------------------------------------------------------------------
# Logging
# ---------------------------------------------------------------------------


class _LogState:
    def __init__(self):
        self.total_loss = 0.0
        self.count = 0
        self.skipped_total = 0
        self.anomaly_total = 0
        self.tokens = 0
        self.t_start = time.perf_counter()

    def reset_window(self):
        self.total_loss = 0.0
        self.count = 0
        self.tokens = 0
        self.t_start = time.perf_counter()


def training_log(cfg: RuntimeConfig, log: _LogState, metrics: dict,
                 iteration: int, consumed_samples: int, writer,
                 timers: Timers) -> None:
    """Fold one step into the window; every ``log_interval`` iterations
    print the reference's log line.  Model TFLOP/s counts a training step
    as three forwards (``3 * flops_per_token``: forward and backward)."""
    loss = float(metrics["loss"])
    if int(metrics.get("anomaly", 0)):
        # an anomalous loss (maybe NaN) stays out of the window average
        log.anomaly_total += 1
    else:
        log.total_loss += loss
        log.count += 1
    log.skipped_total += int(metrics["skipped"])
    if (not cfg.train.log_interval
            or iteration % cfg.train.log_interval != 0):
        return
    elapsed = time.perf_counter() - log.t_start
    per_iter = elapsed / max(log.count, 1)
    tokens_per_sec = log.tokens / elapsed if elapsed > 0 else 0.0
    flops = 3.0 * model_lib.flops_per_token(cfg.model, cfg.train.seq_length)
    tflops = tokens_per_sec * flops / 1e12
    avg_loss = log.total_loss / max(log.count, 1)
    lr = float(metrics["lr"])
    grad_norm = float(metrics["grad_norm"])
    loss_scale = float(metrics.get("loss_scale", 1.0))
    print_rank_0(
        f" iteration {iteration:8d}/{cfg.train.train_iters:8d} |"
        f" consumed samples: {consumed_samples:12d} |"
        f" elapsed time per iteration (ms): {per_iter * 1000.0:.1f} |"
        f" tokens per second: {tokens_per_sec:.1f} |"
        f" model TFLOPs: {tflops:.1f} |"
        f" learning rate: {lr:.3E} |"
        f" lm loss: {avg_loss:.6E} |"
        f" loss scale: {loss_scale:.1f} |"
        f" grad norm: {grad_norm:.3f} |"
        f" number of skipped iterations: {log.skipped_total:3d} |"
        f" number of anomalous iterations: {log.anomaly_total:3d} |")
    for tag, value in (("lm_loss", avg_loss), ("learning_rate", lr),
                       ("grad_norm", grad_norm), ("loss_scale", loss_scale),
                       ("tokens_per_sec", tokens_per_sec)):
        writer.add_scalar(f"train/{tag}", value, iteration)
    timers.log(normalizer=max(log.count, 1))
    log.reset_window()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def _build_train_iterator(cfg: RuntimeConfig, dataset, consumed_samples: int,
                          global_batch_size: int, shuffle: bool,
                          eod_token=None) -> Iterator[dict]:
    accum = global_batch_size // (
        cfg.train.micro_batch_size * cfg.parallel.data_parallel)
    it = BatchIterator(dataset, global_batch_size=global_batch_size,
                       grad_accum=accum, seq_length=cfg.train.seq_length,
                       consumed_samples=consumed_samples, shuffle=shuffle,
                       seed=cfg.train.seed, eod_token=eod_token)

    def checked():
        """Check the first batch's token range once: an out-of-vocab id
        would otherwise fail deep inside the embedding lookup."""
        vocab = cfg.model.vocab_size
        first = True
        for batch in it:
            if first:
                first = False
                lo, hi = int(batch["tokens"].min()), int(batch["tokens"].max())
                if hi >= vocab or lo < 0:
                    raise ValueError(
                        f"dataset token ids span [{lo}, {hi}] but model "
                        f"vocab_size is {vocab}: the corpus was tokenized "
                        f"with a different vocabulary than the model config")
            yield batch

    return checked()


class _PersistentEvalIterator:
    """Validation batches that advance across eval hooks, wrapping to the
    top of the validation set (reference training.py:877-961)."""

    def __init__(self, cfg, dataset, eod_token):
        self.cfg, self.dataset, self.eod = cfg, dataset, eod_token
        self.consumed = 0
        self._gbs = None
        self._it = None

    def iterator(self, gbs: int) -> "_PersistentEvalIterator":
        if self._it is None or gbs != self._gbs:
            self._gbs = gbs
            self._it = _build_train_iterator(
                self.cfg, self.dataset, self.consumed, gbs, False, self.eod)
        return self

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self._it)
        except StopIteration:
            self.consumed = 0
            self._it = _build_train_iterator(
                self.cfg, self.dataset, 0, self._gbs, False, self.eod)
            batch = next(self._it)
        self.consumed += self._gbs
        return batch


def pretrain(
    cfg: RuntimeConfig,
    train_dataset=None,
    valid_dataset=None,
    test_dataset=None,
    params: Optional[PyTree] = None,
    batch_provider: Optional[Callable[[int, int], Iterator[dict]]] = None,
    shuffle: bool = True,
    eod_token: Optional[int] = None,
    device=None,
    on_step: Optional[Callable[[int, dict, float], None]] = None,
) -> TrainState:
    """Train ``cfg.train.train_iters`` iterations on ``device`` (default
    ``cuda``); returns the final state.

    ``batch_provider(consumed_samples, global_batch_size)`` overrides the
    dataset iterator, as in JAX.  ``on_step(iteration, metrics, seconds)``,
    if given, sees every trained step with its wall time (the host clock
    around the step, ending in a device synchronization)."""
    cfg.validate()
    _refuse_unported(cfg)
    t_start = time.time()
    timers = Timers()
    writer = build_writer(cfg.train.tensorboard_dir, cfg.train.wandb_project,
                          cfg.train.wandb_name)

    timers("setup").start()
    art = setup_train_state(cfg, params=params, device=device)
    state = art.state

    # resume (reference load_checkpoint, checkpointing.py:562-678)
    iteration = 0
    consumed_samples = 0
    tag = None
    if cfg.train.load:
        try:
            tag = checkpointing.resolve_load_target(cfg.train.load)
        except FileNotFoundError:
            print_rank_0(f" no checkpoint under {cfg.train.load}; "
                         "starting from scratch")
    if tag is not None:
        # the read fills the template's own tensors: a read that fails
        # part way raises here rather than train on a half-restored state
        state, tag = checkpointing.load_checkpoint(
            cfg.train.load, state, tag, retries=cfg.train.checkpoint_retries)
        # the meta of the iteration actually loaded: under a torn
        # tracker's fallback it differs from the tracker's target
        meta = checkpointing.load_meta(cfg.train.load, tag)
        if tag != checkpointing.RELEASE:
            iteration = int(tag)
            consumed_samples = int(meta.get("consumed_samples", 0))
        print_rank_0(f" loaded checkpoint from {cfg.train.load} at "
                     f"iteration {tag} "
                     f"(consumed_samples={consumed_samples})")
    timers("setup").stop(barrier=True)
    calculator = build_num_microbatches_calculator(
        cfg.train.global_batch_size, cfg.train.micro_batch_size,
        cfg.parallel.data_parallel, cfg.train.rampup_batch_size)
    calculator.update(consumed_samples, False)

    def make_train_iter(consumed, gbs):
        if batch_provider is not None:
            return batch_provider(consumed, gbs)
        if train_dataset is None:
            raise ValueError("no training data")
        return _build_train_iterator(cfg, train_dataset, consumed, gbs,
                                     shuffle, eod_token)

    current_gbs = calculator.get_current_global_batch_size()
    train_iter = make_train_iter(consumed_samples, current_gbs)
    eval_step = None
    if valid_dataset is not None or test_dataset is not None:
        eval_step = make_eval_step(cfg, tuple(cfg.train.metrics), art.device)
    persistent_valid = (None if valid_dataset is None else
                        _PersistentEvalIterator(cfg, valid_dataset, eod_token))

    log = _LogState()
    # the step folds in the iteration (dropout masks; JAX driver.py:664)
    base_rng = drop.key(cfg.train.seed)
    skip_set = set(cfg.train.skip_iters)
    exit_reason = None
    # anomaly rollback needs a checkpoint to roll back to: anchor the run
    # with a save when none exists yet
    rollbacks = 0
    if (cfg.train.anomaly_rollback_after and cfg.train.save
            and checkpointing.latest_complete_iteration(cfg.train.save)
            is None):
        print_rank_0(" anomaly rollback enabled with no checkpoint on "
                     "disk; writing the initial rollback anchor")
        _save(cfg, state, iteration, consumed_samples, timers)
    print_rank_0(f" training starts at iteration {iteration} / "
                 f"{cfg.train.train_iters}")
    with DistSignalHandler() as sig:
        while iteration < cfg.train.train_iters:
            # fault injection: --skip_iters (training.py:397-399,422-426)
            if (iteration + 1) in skip_set:
                try:
                    next(train_iter)
                except StopIteration:
                    train_iter = make_train_iter(consumed_samples,
                                                 current_gbs)
                    next(train_iter)
                iteration += 1
                consumed_samples += current_gbs
                calculator.update(consumed_samples, True)
                state = state._replace(iteration=state.iteration + 1)
                print_rank_0(f" skipping iteration {iteration} (fault "
                             "injection)")
                continue

            # batch-size ramp: rebuild the iterator on a rung change
            new_gbs = calculator.get_current_global_batch_size()
            if new_gbs != current_gbs:
                current_gbs = new_gbs
                train_iter = make_train_iter(consumed_samples, current_gbs)
                print_rank_0(f" global batch size ramped to {current_gbs}")

            timers("batch-generator", log_level=1).start()
            try:
                batch = next(train_iter)
            except StopIteration:
                train_iter = make_train_iter(consumed_samples, current_gbs)
                batch = next(train_iter)
            # chaos hook (inert unless a test armed poison_batches)
            batch = chaos().corrupt_batch(batch, iteration + 1)
            dev_batch = to_device_batch(batch, art.device)
            timers("batch-generator").stop()

            t0 = time.perf_counter()
            timers("train-step").start()
            state, step_metrics = art.step_fn(state, dev_batch, base_rng)
            timers("train-step").stop(wait_for=step_metrics)
            if on_step is not None:
                on_step(iteration + 1, step_metrics, time.perf_counter() - t0)

            iteration += 1
            consumed_samples += current_gbs
            calculator.update(consumed_samples, True)
            log.tokens += current_gbs * cfg.train.seq_length
            training_log(cfg, log, step_metrics, iteration, consumed_samples,
                         writer, timers)

            # K consecutive data anomalies: restore the last complete
            # checkpoint and keep consumed_samples where it is, so the
            # replayed iterations read past the poisoned data
            k_roll = cfg.train.anomaly_rollback_after
            if k_roll and int(step_metrics["anomaly_run"]) >= k_roll:
                state, iteration = rollback_to_last_checkpoint(
                    cfg, state, rollbacks + 1)
                rollbacks += 1
                print_rank_0(
                    f" ANOMALY ROLLBACK #{rollbacks}: {k_roll} consecutive "
                    f"anomalous iterations; restored iteration {iteration} "
                    f"and skipping the poisoned data window "
                    f"(consumed_samples stays at {consumed_samples})")
                log.reset_window()
                continue

            if (persistent_valid is not None and cfg.train.eval_interval
                    and iteration % cfg.train.eval_interval == 0):
                timers("eval").start()
                evaluate_and_print_results(
                    f"iteration {iteration}", cfg, state.params,
                    persistent_valid.iterator(current_gbs), eval_step,
                    art.device, writer, iteration)
                timers("eval").stop()

            if (cfg.train.save and cfg.train.save_interval
                    and iteration % cfg.train.save_interval == 0):
                _save(cfg, state, iteration, consumed_samples, timers)

            if sig.signals_received():
                exit_reason = "signal"
            elif (cfg.train.exit_interval
                    and iteration % cfg.train.exit_interval == 0):
                exit_reason = "exit_interval"
            elif (cfg.train.exit_duration_mins is not None
                    and (time.time() - t_start) / 60.0
                    > cfg.train.exit_duration_mins):
                exit_reason = "exit_duration"
            if exit_reason:
                break

    if exit_reason:
        print_rank_0(f" exiting at iteration {iteration}: {exit_reason}")
        if cfg.train.save:
            _save(cfg, state, iteration, consumed_samples, timers)
        if exit_reason == "signal":
            writer.flush()
            sys.exit(0)
    elif cfg.train.save:
        _save(cfg, state, iteration, consumed_samples, timers)

    if persistent_valid is not None:
        evaluate_and_print_results(
            "the end of training for val data", cfg, state.params,
            persistent_valid.iterator(current_gbs), eval_step, art.device,
            writer, iteration)
    if test_dataset is not None:
        evaluate_and_print_results(
            "the end of training for test data", cfg, state.params,
            _build_train_iterator(cfg, test_dataset, 0, current_gbs, False,
                                  eod_token),
            eval_step, art.device, writer, iteration)
    writer.flush()
    elapsed = datetime.timedelta(seconds=int(time.time() - t_start))
    print_rank_0(f" training finished in {elapsed} at iteration {iteration}")
    return state


def _save(cfg: RuntimeConfig, state, iteration: int, consumed_samples: int,
          timers: Timers) -> None:
    timers("save-checkpoint").start()
    path = checkpointing.save_checkpoint(
        cfg.train.save, state, cfg, iteration,
        meta={"consumed_samples": consumed_samples},
        retries=cfg.train.checkpoint_retries,
        keep=cfg.train.keep_latest_checkpoints)
    timers("save-checkpoint").stop()
    print_rank_0(f" saved checkpoint to {path}")


def rollback_to_last_checkpoint(cfg: RuntimeConfig, state, attempt: int = 1):
    """Restore the newest complete checkpoint over ``state`` →
    ``(restored_state, iteration)``.  ``attempt`` is the 1-based rollback
    count of this run; past ``anomaly_max_rollbacks`` it aborts instead of
    thrashing on data that never recovers."""
    if attempt > cfg.train.anomaly_max_rollbacks:
        raise RuntimeError(
            f"giving up after {cfg.train.anomaly_max_rollbacks} anomaly "
            "rollbacks: the loss anomaly persists beyond skip-ahead "
            "recovery (bad data shard? diverged run?)")
    root = cfg.train.save or cfg.train.load
    if not root:
        raise RuntimeError(
            "anomaly_rollback_after is set but neither train.save nor "
            "train.load provides a checkpoint root to roll back to")
    state, tag = checkpointing.load_checkpoint(
        root, state, retries=cfg.train.checkpoint_retries)
    metrics_lib.RESILIENCE_EVENTS.inc("rollbacks")
    return state, (0 if tag == checkpointing.RELEASE else int(tag))
