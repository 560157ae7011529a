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
- ``make_eval_step`` / ``evaluate``: the forward-only LM loss and the
  registry metrics of ``train.metrics`` (``metrics.py``), written to the
  writer as ``valid/<name>`` beside ``valid/lm_loss_ppl``.
- ``ProfilerWindow``: ``torch.profiler`` (CPU and CUDA activity) over
  iterations ``[profile_step_start, profile_step_end]``, written as one
  Chrome trace into ``profile_dir``.
- ``rollback_to_last_checkpoint``: the rollback's restore.
- ``pretrain_custom``: the loop of the families whose batches and losses
  are not the decoder LM's (BERT, T5, the ICT biencoder and the BERT
  tasks): ``dataset[i]`` dicts, a ``loss_fn`` and an optional
  ``eval_loss_fn``, resume from ``save``/``load``.

TensorBoard and wandb export go through ``utils/writers.build_writer``.

Data, tensor and sequence parallelism and ZeRO-1 run one process a rank
(``torchrun``; ``initialize.initialize_distributed`` joins the world):
``setup_train_state`` builds the mesh (``parallel/mesh.build_mesh``),
keeps this rank's shards of the params (``models/sharding``) and of the
optimizer state, and hands the step its ``ParallelPlan``; each rank takes
its dp block of every ``[accum, micro_total, ...]`` batch, the loop runs
inside the mesh, and the log, the writers, the profiler window and the
checkpoint files are rank 0's.  Every rank reads the same data and draws
the same full params from the seed, so the ranks agree without a
broadcast.

Pipeline parallelism lays the layer stack in JAX's pipeline layout
(``parallel/pipeline.to_pipeline_params``, its specs
``pipeline_param_specs``: checkpoints hold ``[vpp, pp, lpc, ...]``
leaves, as JAX's do) and evaluates through the pipelined forward
(``make_pipeline_eval_step``); context parallelism cuts each eval
batch's sequence as the step does, the loss summed and the metrics'
per-token values gathered over cp.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
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
from ..initialize import is_rank_0
from ..models import model as model_lib
from ..models.transformer import rope_tables
from ..obs.logging import EVENT_LOG
from ..ops import dropout as drop
from ..parallel import mappings
from ..parallel import mesh as mesh_lib
from ..parallel import pipeline as pipe
from ..parallel import ring_attention
from ..parallel.cross_entropy import cross_entropy, masked_mean_loss
from ..resilience import chaos
from ..utils.timers import Timers
from ..utils.tree import tree_map
from ..utils.writers import NullWriter, build_writer
from .microbatches import build_num_microbatches_calculator
from .step import TrainState, context_parallel_block, init_train_state, \
    loss_denominators, make_plan, make_train_step, to_device_batch

PyTree = Any


def print_rank_0(*args, **kwargs):
    """Rank 0 speaks (the only rank of a one-process run)."""
    if is_rank_0():
        print(*args, **kwargs, flush=True)


def _writer(cfg: RuntimeConfig, **kw):
    """Rank 0's writer; the other ranks write nothing."""
    if not is_rank_0():
        return NullWriter()
    return build_writer(cfg.train.tensorboard_dir, cfg.train.wandb_project,
                        cfg.train.wandb_name, **kw)


class ProfilerWindow:
    """``torch.profiler`` over the iterations ``[start, end]`` (JAX's
    ``jax.profiler`` window, driver.py:668-698).  ``maybe_start(it)`` runs
    before iteration ``it`` (on the skip path too), ``maybe_stop(it)``
    after it; ``close`` ends an open window on any exit, an exception
    included, where the partial capture is the one wanted.  The trace is
    ``<profile_dir>/trace_iters_<first>-<last>.json`` (Chrome format).
    The upper bound keeps a resumed run that starts past the window from
    writing a stray trace."""

    def __init__(self, profile_dir: Optional[str], start: int, end: int,
                 device):
        # one trace, rank 0's
        self.dir = profile_dir if is_rank_0() else None
        self.start, self.end = start, end
        self.device = torch.device(device)
        self._prof = None
        self._first = None

    def maybe_start(self, next_it: int) -> None:
        if (self.dir and self._prof is None
                and self.start <= next_it <= self.end):
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._first = next_it
            print_rank_0(f" profiler: tracing iterations {next_it}.."
                         f"{self.end} -> {self.dir}")

    def maybe_stop(self, done_it: int) -> None:
        if self._prof is not None and done_it >= self.end:
            self.close("window complete", done_it)

    def close(self, reason: str = "closed at loop exit",
              last: Optional[int] = None) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        last = self.end if last is None else last
        path = os.path.join(self.dir,
                            f"trace_iters_{self._first}-{last}.json")
        prof.export_chrome_trace(path)
        print_rank_0(f" profiler: trace written to {path} ({reason})")


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
    """What ``pretrain`` needs per run: state, step, device, and under
    parallelism the mesh and the step's plan (else None)."""

    def __init__(self, cfg, state, step_fn, device, mesh=None, plan=None):
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.device = device
        self.mesh = mesh
        self.plan = plan

    def in_mesh(self):
        """The context the loop runs in: the mesh, if there is one."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_lib.use_mesh(self.mesh)


def _wants_mesh(cfg: RuntimeConfig, device) -> bool:
    """Whether the run builds a mesh: a world is initialized, or the
    degrees ask for one (then the world is joined from the launcher's
    environment; without one ``build_mesh`` says how to launch)."""
    import torch.distributed as dist

    from ..initialize import initialize_distributed

    if cfg.parallel.world_size > 1 and not dist.is_initialized():
        initialize_distributed(device)
    return cfg.parallel.world_size > 1 or dist.is_initialized()


def _replicated_specs(params: PyTree) -> PyTree:
    return tree_map(lambda t: (None,) * t.ndim, params)


def setup_train_state(cfg: RuntimeConfig, params: Optional[PyTree] = None,
                      device=None, param_specs: Optional[PyTree] = None,
                      loss_fn=None, pipeline_loss_fn=None
                      ) -> TrainingArtifacts:
    """Params (``params``, or ``init_params`` from ``cfg.train.seed``) and a
    fresh optimizer state on ``device`` (default ``cuda``), and the step.

    In a world of several ranks (or any initialized one) the mesh of
    ``cfg.parallel`` is built and ``params`` (whole, the same on every
    rank) are cut to this rank's shards by ``param_specs`` (default the
    decoder's ``models.sharding.param_specs``); the optimizer state and
    the step follow the plan.  A mesh of one rank keeps the one-device
    state and step.  ``pipeline_loss_fn`` goes to the step
    (``make_train_step``)."""
    device = model_lib.default_device(device)
    if cfg.parallel.fsdp > 1:
        # JAX's training specs never name the fsdp axis: its step keeps
        # the weights and the batch whole on every fsdp rank and repeats
        # the step there
        raise ValueError(
            f"fsdp = {cfg.parallel.fsdp} is the serving residency axis "
            "(models/sharding.serving_param_specs); JAX's training step "
            "replicates weights and batch over it and repeats the step on "
            "each fsdp rank. Train with data_parallel instead")
    tp = cfg.parallel.tensor_parallel
    mesh = plan = None
    if _wants_mesh(cfg, device):
        from ..models import sharding

        mesh = mesh_lib.build_mesh(cfg.parallel)
        if param_specs is None and loss_fn is None:
            param_specs = pipe.pipeline_param_specs(
                sharding.param_specs(cfg.model, cfg.parallel), cfg.parallel)
        if params is None and param_specs is not None:
            params = _init_sharded(cfg, device, param_specs, mesh)
        else:
            if params is None:
                params = model_lib.init_params(cfg.model, seed=cfg.train.seed,
                                               device=device, tp=tp)
            if loss_fn is None:  # whole params in the pipeline layout
                params = pipe.to_pipeline_params(params, cfg.parallel)
            if param_specs is None:
                if tp > 1:
                    raise ValueError("a custom loss under tensor "
                                     "parallelism needs its param_specs")
                param_specs = _replicated_specs(params)
            params = sharding.shard_params(params, param_specs, mesh)
        plan = make_plan(cfg, mesh, param_specs, params)
    elif params is None:
        params = model_lib.init_params(cfg.model, seed=cfg.train.seed,
                                       device=device, tp=tp)
    state = init_train_state(cfg, params,
                             zero=None if plan is None else plan.zero)
    return TrainingArtifacts(cfg, state,
                             make_train_step(cfg, device, loss_fn, plan,
                                             pipeline_loss_fn),
                             device, mesh, plan)


def _init_sharded(cfg: RuntimeConfig, device, specs: PyTree,
                  mesh) -> PyTree:
    """``init_params`` from ``cfg.train.seed``, each drawn matrix cut to
    this rank's block as soon as it is drawn (one whole matrix alive at a
    time, the draws unchanged), then the norms and biases; under pp the
    layer leaves in the pipeline layout first."""
    from ..models import sharding

    cut = set()
    pp, vpp = (cfg.parallel.pipeline_parallel,
               cfg.parallel.virtual_pipeline_stages)

    def staged(path, t):
        return pipe.to_stage_layers(t, pp, vpp) \
            if pp > 1 and path[0] == "layers" else t

    def place(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        out = sharding.shard_tensor(staged(path, t), spec, mesh)
        cut.add(id(out))
        return out

    params = model_lib.init_params(cfg.model, seed=cfg.train.seed,
                                   device=device,
                                   tp=cfg.parallel.tensor_parallel,
                                   place=place)
    return {key: tree_map(
        lambda p, s, k=key: p if id(p) in cut
        else sharding.shard_tensor(staged((k,), p), s, mesh),
        sub, specs[key]) for key, sub in params.items()}


def _dp_block(batch: dict, mesh, axis: int = 1) -> dict:
    """This rank's dp block of a host batch along ``axis`` (the microbatch
    axis of ``[accum, micro_total, ...]``)."""
    if mesh is None or mesh.size("dp") == 1:
        return batch
    dp, i = mesh.size("dp"), mesh.index("dp")

    def block(v):
        n = v.shape[axis] // dp
        return np.take(v, np.arange(i * n, (i + 1) * n), axis=axis)

    return {k: block(v) for k, v in batch.items()}


def _eval_denominators(batch: dict, mesh) -> dict:
    """An eval batch (one microbatch, this rank's dp block) with the
    global loss-mask denominator, as the train step gives its own."""
    if mesh is None:
        return batch
    return loss_denominators(batch, mesh.group("dp"), lead=0,
                             whole=mesh.size("cp") > 1)


def _dp_mean(values: dict, mesh) -> dict:
    """Host numbers averaged over dp (every rank gets the mean)."""
    if mesh is None or mesh.size("dp") == 1 or not values:
        return values
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    mappings.all_reduce(t, mesh.group("dp"))
    return {k: float(v) / mesh.size("dp") for k, v in zip(keys, t.tolist())}


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def make_eval_step(cfg: RuntimeConfig, metric_names=(), device=None):
    """Forward-only ``eval_step(params, batch) -> {"lm_loss": ..., <name>:
    ...}``, 0-d tensors: the LM loss and each registry metric named.
    Under cp each rank runs its block of the sequence (after the zigzag
    permutation, JAX ``driver.py:248-250``): the loss is summed over cp
    and the metrics see every rank's tokens."""
    metrics_lib.validate_metric_names(metric_names)
    rope = rope_tables(cfg.model, device=model_lib.default_device(device))

    @torch.no_grad()
    def eval_step(params, batch):
        mesh = mesh_lib.current_mesh()
        batch = context_parallel_block(cfg, batch, mesh)
        logits = model_lib.forward(
            cfg.model, params, batch["tokens"],
            position_ids=batch.get("position_ids"),
            segment_ids=batch.get("segment_ids"), rope=rope)
        # under tp the whole vocabulary for the metrics (evaluation only)
        logits = mappings.all_gather(logits, mesh_lib.axis_info("tp")[0], -1)
        per_token = cross_entropy(logits, batch["labels"],
                                  vocab_size=cfg.model.vocab_size)
        loss = masked_mean_loss(per_token, batch["loss_mask"],
                                batch.get("loss_denom"))
        cp_group = mesh_lib.axis_info("cp")[0]
        out = {"lm_loss": mappings.all_reduce(loss, cp_group)}
        if metric_names and cp_group is None:
            out.update(metrics_lib.compute_metrics(metric_names, batch,
                                                   logits, per_token))
        elif metric_names:
            def whole(t):
                return mappings.all_gather(t.contiguous(), cp_group, 1)

            correct = (torch.argmax(logits, dim=-1)
                       == batch["labels"]).float()
            seqs = {k: whole(v) for k, v in batch.items()
                    if v is not None and v.ndim == 2}
            out.update(metrics_lib.compute_metrics(
                metric_names, seqs, None, whole(per_token),
                correct=whole(correct)))
        return out

    return eval_step


def make_pipeline_eval_step(cfg: RuntimeConfig, metric_names=(),
                            device=None):
    """Forward-only loss and registry metrics through the pipelined
    forward for pp > 1 (JAX ``make_pipeline_eval_step``): the streamed
    head's per-token loss and correctness from the last stage, so every
    registry metric works.  ``batch`` leaves are ``[M, mb, ...]``; under
    cp each rank runs its block of the sequence, the loss is summed over
    cp and the metrics see every rank's tokens, as ``make_eval_step``'s."""
    metrics_lib.validate_metric_names(metric_names)
    rope = rope_tables(cfg.model, device=model_lib.default_device(device))

    @torch.no_grad()
    def eval_step(params, batch):
        batch = context_parallel_block(cfg, batch, mesh_lib.current_mesh())
        cp_group = mesh_lib.axis_info("cp")[0]
        if not metric_names:
            return {"lm_loss": mappings.all_reduce(pipe.pipeline_loss(
                cfg, params, batch, rope=rope), cp_group)}
        loss, stats = pipe.pipeline_loss(cfg, params, batch, rope=rope,
                                         return_stats=True)

        def flat(v):  # [M, mb, s] → [M * mb, s], under cp the whole s
            v = mappings.all_gather(v.contiguous(), cp_group, 2)
            return v.reshape((-1,) + tuple(v.shape[2:]))

        out = {"lm_loss": mappings.all_reduce(loss, cp_group)}
        out.update(metrics_lib.compute_metrics(
            metric_names, {k: flat(v) for k, v in batch.items()
                           if v is not None and v.ndim == 3},
            None, flat(stats["per_token_loss"]),
            correct=flat(stats["correct"])))
        return out

    return eval_step


def evaluate(cfg: RuntimeConfig, params, data_iterator, eval_step,
             device, eval_iters: Optional[int] = None,
             flatten: bool = True) -> dict[str, float]:
    """Average eval metrics over ``eval_iters`` batches, each
    ``[accum, micro, ...]`` flattened to ``[accum * micro, ...]`` (kept
    as it is with ``flatten=False``: the pipelined eval step's
    microbatches); under a current mesh each rank evaluates its dp block
    and the averages are averaged over dp."""
    mesh = mesh_lib.current_mesh()
    if eval_iters is None:
        eval_iters = cfg.train.eval_iters
    totals: dict[str, float] = {}
    n = 0
    for _ in range(eval_iters):
        try:
            batch = next(data_iterator)
        except StopIteration:
            break
        batch = _dp_block(batch, mesh)
        if flatten:
            batch = {k: np.reshape(v, (-1,) + v.shape[2:])
                     for k, v in batch.items()}
            batch = _eval_denominators(to_device_batch(batch, device), mesh)
        else:
            batch = to_device_batch(batch, device)
            if mesh is not None:
                batch = loss_denominators(batch, mesh.group("dp"),
                                          whole=mesh.size("cp") > 1)
        out = eval_step(params, batch)
        for k, v in out.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        n += 1
    return _dp_mean({k: v / max(n, 1) for k, v in totals.items()}, mesh)


def evaluate_and_print_results(prefix: str, cfg, params, data_iterator,
                               eval_step, device, writer=None,
                               iteration: int = 0) -> dict[str, float]:
    results = evaluate(cfg, params, data_iterator, eval_step, device,
                       flatten=cfg.parallel.pipeline_parallel == 1)
    string = f" validation loss at {prefix} | "
    for k, v in results.items():
        string += f"{k}: {v:.6E} | "
        if writer is not None:
            writer.add_scalar(f"valid/{k}", v, iteration)
        if k == "lm_loss":
            ppl = float(np.exp(min(20.0, v)))
            string += f"lm loss PPL: {ppl:.6E} | "
            if writer is not None:
                writer.add_scalar("valid/lm_loss_ppl", ppl, iteration)
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
    if not is_rank_0():  # rank 0 logs
        log.reset_window()
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
    EVENT_LOG.emit(
        "training", "log_window", iteration=iteration,
        consumed_samples=consumed_samples, lm_loss=round(avg_loss, 6),
        tokens_per_sec=round(tokens_per_sec, 3),
        step_time_s=round(per_iter, 6), learning_rate=lr,
        grad_norm=round(grad_norm, 6), skipped=log.skipped_total,
        anomalies=log.anomaly_total)
    for tag, value in (("lm_loss", avg_loss), ("learning_rate", lr),
                       ("grad_norm", grad_norm), ("loss_scale", loss_scale),
                       ("tokens_per_sec", tokens_per_sec),
                       ("consumed_samples", consumed_samples),
                       ("anomalous_iterations", log.anomaly_total)):
        writer.add_scalar(f"train/{tag}", value, iteration)
    for name, value in sorted(
            metrics_lib.RESILIENCE_EVENTS.snapshot().items()):
        writer.add_scalar(f"resilience/{name}", value, iteration)
    timers.write(writer, iteration, reset=False)
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
    t_start = time.time()
    timers = Timers()
    writer = _writer(cfg)

    timers("setup").start()
    art = setup_train_state(cfg, params=params, device=device)
    with art.in_mesh():
        return _pretrain_loop(cfg, art, t_start, timers, writer,
                              train_dataset, valid_dataset, test_dataset,
                              batch_provider, shuffle, eod_token, on_step)


def _pretrain_loop(cfg, art, t_start, timers, writer, train_dataset,
                   valid_dataset, test_dataset, batch_provider, shuffle,
                   eod_token, on_step) -> TrainState:
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
            cfg.train.load, state, tag, retries=cfg.train.checkpoint_retries,
            plan=art.plan)
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
        eval_step = (make_pipeline_eval_step
                     if cfg.parallel.pipeline_parallel > 1
                     else make_eval_step)(cfg, tuple(cfg.train.metrics),
                                          art.device)
    persistent_valid = (None if valid_dataset is None else
                        _PersistentEvalIterator(cfg, valid_dataset, eod_token))

    profiler = ProfilerWindow(cfg.train.profile_dir,
                              cfg.train.profile_step_start,
                              cfg.train.profile_step_end, art.device)
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
        _save(cfg, state, iteration, consumed_samples, timers, art.plan)
    print_rank_0(f" training starts at iteration {iteration} / "
                 f"{cfg.train.train_iters}")
    with DistSignalHandler() as sig:
        try:
            while iteration < cfg.train.train_iters:
                profiler.maybe_start(iteration + 1)
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
                    profiler.maybe_stop(iteration)
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
                dev_batch = to_device_batch(_dp_block(batch, art.mesh),
                                            art.device)
                timers("batch-generator").stop()

                t0 = time.perf_counter()
                timers("train-step").start()
                state, step_metrics = art.step_fn(state, dev_batch, base_rng)
                timers("train-step").stop(wait_for=step_metrics)
                if on_step is not None:
                    on_step(iteration + 1, step_metrics,
                            time.perf_counter() - t0)
                # stop right after the window's last step, before the eval
                # and save hooks, so the capture holds train steps
                profiler.maybe_stop(iteration + 1)

                iteration += 1
                consumed_samples += current_gbs
                calculator.update(consumed_samples, True)
                log.tokens += current_gbs * cfg.train.seq_length
                training_log(cfg, log, step_metrics, iteration,
                             consumed_samples, writer, timers)

                # K consecutive data anomalies: restore the last complete
                # checkpoint and keep consumed_samples where it is, so the
                # replayed iterations read past the poisoned data
                k_roll = cfg.train.anomaly_rollback_after
                if k_roll and int(step_metrics["anomaly_run"]) >= k_roll:
                    state, iteration = rollback_to_last_checkpoint(
                        cfg, state, rollbacks + 1, art.plan)
                    rollbacks += 1
                    print_rank_0(
                        f" ANOMALY ROLLBACK #{rollbacks}: {k_roll} "
                        f"consecutive anomalous iterations; restored "
                        f"iteration {iteration} "
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
                    _save(cfg, state, iteration, consumed_samples, timers,
                          art.plan)

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
        finally:
            profiler.close()

    if exit_reason:
        print_rank_0(f" exiting at iteration {iteration}: {exit_reason}")
        if cfg.train.save:
            _save(cfg, state, iteration, consumed_samples, timers, art.plan)
        if exit_reason == "signal":
            writer.flush()
            sys.exit(0)
    elif cfg.train.save:
        _save(cfg, state, iteration, consumed_samples, timers, art.plan)

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
          timers: Timers, plan=None) -> None:
    timers("save-checkpoint").start()
    path = checkpointing.save_checkpoint(
        cfg.train.save, state, cfg, iteration,
        meta={"consumed_samples": consumed_samples},
        retries=cfg.train.checkpoint_retries,
        keep=cfg.train.keep_latest_checkpoints, plan=plan)
    timers("save-checkpoint").stop()
    print_rank_0(f" saved checkpoint to {path}")


def rollback_to_last_checkpoint(cfg: RuntimeConfig, state, attempt: int = 1,
                                plan=None):
    """Restore the newest complete checkpoint over ``state`` →
    ``(restored_state, iteration)``.  ``attempt`` is the 1-based rollback
    count of this run; past ``anomaly_max_rollbacks`` it aborts instead of
    thrashing on data that never recovers.  Under ``plan`` every rank
    restores its blocks."""
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
        root, state, retries=cfg.train.checkpoint_retries, plan=plan)
    metrics_lib.RESILIENCE_EVENTS.inc("rollbacks")
    EVENT_LOG.emit("training", "rollback", checkpoint_root=str(root),
                   restored_tag=str(tag))
    return state, (0 if tag == checkpointing.RELEASE else int(tag))


# ---------------------------------------------------------------------------
# The loop of the other families (the forward_step_func hook of the
# reference's pretrain(), training.py:55): pretrain_bert / pretrain_t5 /
# pretrain_ict and the BERT tasks, whose batches and losses are not the
# decoder LM's
# ---------------------------------------------------------------------------


def _stack_samples(samples: list, shape: tuple) -> dict:
    """``dataset[i]`` dicts of numpy arrays → one array per key of
    ``shape + sample shape``."""
    return {k: np.stack([s[k] for s in samples]).reshape(
        shape + np.asarray(samples[0][k]).shape) for k in samples[0]}


def pretrain_custom(
    cfg: RuntimeConfig,
    dataset,
    params: PyTree,
    loss_fn,
    valid_dataset=None,
    eval_loss_fn=None,
    param_specs: Optional[PyTree] = None,
    pipeline_loss_fn=None,
    device=None,
    on_step: Optional[Callable[[int, dict, float], None]] = None,
) -> TrainState:
    """The training loop of a model family with its own batches and loss
    (JAX ``training/driver.py:pretrain_custom``), on ``device`` (default
    ``cuda``; ``params`` are moved there).

    ``dataset[i]`` yields a dict of numpy arrays; a step's samples are
    stacked to ``[accum, micro_total, ...]`` and the step runs
    ``loss_fn(cfg, params, microbatch, rng, deterministic)`` with dropout
    on.  The sample order is a pure function of (seed, consumed samples):
    one permutation per epoch, so a resume from ``train.load`` (or a
    tracker under ``train.save``) replays it exactly.  Every
    ``eval_interval`` iterations ``eval_loss_fn`` (else ``loss_fn``) runs
    without dropout on ``eval_iters`` windows of ``valid_dataset``.
    ``on_step(iteration, metrics, seconds)`` sees each step, as in
    ``pretrain``.  ``param_specs`` (``encdec.bert_param_specs`` and its
    kin) lays the whole ``params`` over the mesh of ``cfg.parallel``
    (``setup_train_state``); each rank trains on its dp block of every
    batch.  Under cp every rank takes the whole batch and the ring splits
    the attention's sequence (``training/step.py``).

    With ``pipeline_loss_fn`` (``pp > 1``) the step runs the family's
    pipeline (``parallel/pipeline_encdec.t5_pipeline_loss`` or
    ``bert_pipeline_loss``); ``params`` and ``param_specs`` must then be
    in its stage-stacked layout, the grad-accumulation count is the
    schedule's microbatch count, and evaluation reuses the pipelined
    schedule on one group of ``[1, micro_total, ...]`` (JAX's checks,
    ``training/driver.py:935-943``).  A custom loss under pp without one
    raises, as JAX's step does; so does ep > 1 (the families hold no
    experts)."""
    cfg.validate()
    par = cfg.parallel
    if pipeline_loss_fn is not None:
        if par.pipeline_parallel < 2 or param_specs is None:
            raise ValueError("pipeline_loss_fn needs pipeline_parallel > 1 "
                             "and the stage-stacked param_specs")
        if cfg.grad_accum_steps != par.num_microbatches:
            raise ValueError(
                f"global_batch_size/(micro_batch*dp) = "
                f"{cfg.grad_accum_steps} must equal parallel.num_microbatches"
                f" ({par.num_microbatches}) for the pipelined step")
        if eval_loss_fn is not None:
            raise ValueError("eval_loss_fn is not supported with "
                             "pipeline_loss_fn — evaluation reuses the "
                             "pipelined schedule")
    elif par.pipeline_parallel > 1:
        raise NotImplementedError(
            "custom loss_fn is not supported with pipeline parallelism "
            "(pass pipeline_loss_fn for the encdec families)")
    if par.expert_parallel > 1:
        raise NotImplementedError(
            "pretrain_custom: expert_parallel > 1 has no experts to split: "
            "MoE is not plumbed through the encoder stacks (JAX "
            "models/encdec.py:83, :215 assert num_experts == 0)")
    device = model_lib.default_device(device)
    timers = Timers()
    writer = _writer(cfg, config=cfg.to_dict())
    params = tree_map(lambda t: t.to(device), params)
    art = setup_train_state(cfg, params, device, param_specs, loss_fn,
                            pipeline_loss_fn)
    if pipeline_loss_fn is not None:
        def eval_loss_fn(c, p, mb, rng, deterministic):
            return pipeline_loss_fn(c, p, mb, backward=False)[1]
    with art.in_mesh():
        return _custom_loop(cfg, art, dataset, loss_fn, valid_dataset,
                            eval_loss_fn, on_step, timers, writer,
                            pipelined=pipeline_loss_fn is not None)


def _custom_loop(cfg, art, dataset, loss_fn, valid_dataset, eval_loss_fn,
                 on_step, timers, writer, pipelined=False) -> TrainState:
    state, step_fn, device = art.state, art.step_fn, art.device
    iteration = 0
    consumed = 0
    if cfg.train.load or (cfg.train.save and checkpointing.read_tracker(
            cfg.train.save) is not None):
        root = cfg.train.load or cfg.train.save
        try:
            state, it = checkpointing.load_checkpoint(
                root, state, retries=cfg.train.checkpoint_retries,
                plan=art.plan)
            if it != checkpointing.RELEASE:
                iteration = int(it)
                consumed = int(checkpointing.load_meta(root, it).get(
                    "consumed_samples", 0))
            print_rank_0(f" loaded checkpoint from {root} at iteration "
                         f"{it} (consumed_samples={consumed})")
        except FileNotFoundError:
            pass

    gbs = cfg.train.global_batch_size
    accum = cfg.grad_accum_steps
    micro_total = gbs // accum
    n = len(dataset)
    log = _LogState()

    @functools.lru_cache(maxsize=2)
    def epoch_order(epoch: int) -> np.ndarray:
        """One permutation per epoch (a batch straddles at most two):
        resume reproduces the order, and evaluation's draws cannot move
        it (the resumable-sampler contract of the reference's
        data_samplers.py:49-96)."""
        return np.random.default_rng((cfg.train.seed, epoch)).permutation(n)

    def sample_index(position: int) -> int:
        return int(epoch_order(position // n)[position % n])

    eval_fn = eval_loss_fn or loss_fn
    eval_rng = np.random.default_rng(cfg.train.seed + 977)
    base_rng = drop.key(cfg.train.seed)
    while iteration < cfg.train.train_iters:
        samples = [dataset[sample_index(consumed + j)] for j in range(gbs)]
        batch = to_device_batch(_dp_block(
            _stack_samples(samples, (accum, micro_total)), art.mesh), device)
        t0 = time.perf_counter()
        timers("train-step").start()
        state, metrics = step_fn(state, batch, base_rng)
        timers("train-step").stop(wait_for=metrics)
        if on_step is not None:
            on_step(iteration + 1, metrics, time.perf_counter() - t0)
        iteration += 1
        consumed += gbs
        log.tokens += gbs * cfg.train.seq_length
        training_log(cfg, log, metrics, iteration, consumed, writer, timers)

        if (cfg.train.save and cfg.train.save_interval
                and iteration % cfg.train.save_interval == 0):
            _save(cfg, state, iteration, consumed, timers, art.plan)

        if (valid_dataset is not None and cfg.train.eval_interval
                and iteration % cfg.train.eval_interval == 0
                and cfg.train.eval_iters):
            nv = len(valid_dataset)
            losses = []
            # one group of microbatches [1, micro_total, ...] through the
            # pipelined schedule, else one microbatch [micro_total, ...]
            lead = (1,) if pipelined else ()
            with torch.no_grad(), ring_attention.whole_sequence(
                    art.mesh is not None and art.mesh.size("cp") > 1):
                for v0 in eval_rng.integers(0, nv,
                                            size=cfg.train.eval_iters):
                    vs = [valid_dataset[int((v0 + j) % nv)]
                          for j in range(micro_total)]
                    vb = to_device_batch(_dp_block(
                        _stack_samples(vs, lead + (micro_total,)), art.mesh,
                        len(lead)), device)
                    if art.mesh is not None:
                        vb = loss_denominators(vb, art.mesh.group("dp"),
                                               lead=len(lead))
                    losses.append(float(eval_fn(cfg, state.params, vb, None,
                                                True)))
            loss = _dp_mean({"loss": float(np.mean(losses))},
                            art.mesh)["loss"]
            print_rank_0(f" validation loss at iteration {iteration}: "
                         f"{loss:.6E}")
            writer.add_scalar("valid/loss", loss, iteration)

    if cfg.train.save:
        _save(cfg, state, iteration, consumed, timers, art.plan)
    writer.flush()
    return state
