"""Continuous-batching serving engine over a paged KV pool (mirror of
``megatron_llm_tpu/serving/engine.py`` in its base configuration).

One scheduler thread owns the device state and interleaves, per
iteration:

1. **admission**: while a slot is free, the queue has work and the pool
   can reserve the request's worst-case block count, prefill the prompt
   (padded up to a multiple of ``prefill_bucket``) into a batch-1 dense
   cache with one ``forward_cached(empty_cache=True)`` and publish it into
   freshly allocated pool blocks.  With the prefix cache (the default
   ``prefix_cache_blocks=256``) the longest cached block-aligned prefix of
   the prompt enters the slot's table by ref bump and only the suffix is
   prefilled, over a gathered view of the shared blocks, at the match's
   offset; every prompt's last piece starts at its last whole block
   (``_prefill_cached``), so a repeated prompt commits the cold run's
   tokens bit for bit; a retiring slot offers its prompt's blocks back;
2. **one batched decode step** over every slot (free slots ride along
   against the trash block): ``forward_cached_paged`` with per-slot fills,
   then per-slot greedy / temperature / top-k / top-p sampling whose
   randomness is a per-REQUEST stream keyed on (seed, token counter), so a
   request samples the same tokens whatever slot it lands in and whoever
   shares its batch;
3. **retirement** on EOS, token budget, cancel or deadline.

With ``pipeline_decode`` (the default) step N's sampled tokens stay on the
device and feed step N+1 directly while their host copy streams back;
retirement then lags one step and the extra token sampled for a finished
request is masked, never committed, so committed trajectories are the
same as with ``pipeline_decode=False``.

Greedy decoding reproduces the JAX engine's tokens (tests compare them).
Sampled decoding cannot match ``jax.random`` draw for draw; it keeps the
JAX engine's invariants instead (same seed → same output, independent of
slot and batch).

Decode routes are resolved at ``start()`` as in JAX: a stack that
``kernels/decode_step.fused_paged_decode_eligible`` accepts (the default
``cfg.fused_decode=True`` on a Llama-family model) decodes each step in
one whole-stack launch over the pool (K13); anything else, or
``fused_decode=False``, takes the composed per-layer route.  Quantized
serving runs as in JAX: ``cfg.kv_cache_quant="int8"`` keeps the pool as
int8 ``{"q", "scale"}`` pairs, and params from
``ops/quant.quantize_params`` (the ``int8``, ``int4`` and ``mixed``
policies) go through ``mm`` on the composed route and are dequantized
inside the fused kernel.  Every decode step is counted in
``metrics.step_routes`` under ``precision_route(params)`` as fused or
fallback.

Speculative decoding (``EngineConfig.spec_draft_len > 0``) with the host
n-gram drafter: when some greedy slot's context repeats its trailing
n-gram, the pipeline is flushed and one verify step feeds every slot's
``[pending, draft...]`` window (K14 on the fused route, W sequential
composed steps otherwise), accepts the longest draft prefix that greedy
decoding would have produced, and commits it plus one token.  With a
resident draft model (``draft_cfg``/``draft_params``) the draft model
instead proposes a candidate tree per greedy slot: its forwards run over
a shadow pool addressed through the target's block tables, the target
scores every node in one tree verify (K14's tree mode), and the longest
root path the target's argmax agrees with commits, its rows packed to
depth positions with ``cache_move_rows``.  Greedy outputs are the same
tokens as without speculation.

Span tracing (``trace=True``, the default) records the JAX engine's
spans into ``self.trace`` (``obs/trace.py``, GET /trace) and names the
device phases with NVTX ranges on the card.

Multi-tenant LoRA (``adapters=AdapterRegistry(...)`` with
``EngineConfig(adapter_cache_slots=n)``): a request may name a registered
``adapter_id``.  Admission pins the adapter in the registry's device arena
(a request whose adapter finds every arena slot pinned parks at the queue
head, as under pool pressure) and every step carries the arena and a
per-slot arena-slot vector, turned into the one-hot mask on the device:
the fused routes run the kernels' LoRA epilogue (K13 a decode step, K14 a
verify step), the composed route each layer's ``_lora_add``, and rows of
other adapters, or none, share the batch with bits of their own.  Adapter
requests neither match nor seed the prefix cache (their K/V rows carry
the adapter's wk/wv deltas), and a resident draft proposes under the base
model while the target verifies under the requester's adapter.
``swap_params`` replaces the base weights at an iteration boundary and
leaves the arena as it is.

Chunked prefill (``prefill_chunk``, Sarathi-style as in JAX): admission
prefills at most one chunk of one prompt per scheduler iteration, between
decode steps, so a long prompt does not freeze the active streams.  The
first chunk is a ``forward_cached(empty_cache=True)`` (the flash kernel),
each later one a ``forward_cached`` at its offset over the batch-1 working
cache (the masked cached-score route); the block size defaults to the
chunk.  Chunks start at multiples of the chunk; a prefix hit resumes at
the last chunk start at or before its match and recomputes the shared
rows after it, so a repeated prompt runs the cold run's last chunk on the
same rows.  Requests that want prompt logprobs take the whole-prompt
route.

Tiered KV (``host_kv_blocks > 0``): a pinned host arena behind the pool
(``block_pool.HostKVTier``).  The prefix cache's eviction victims spill to
it and are promoted back at their next match; an admission that the pool
cannot reserve for first squeezes the prefix cache, then preempts active
decodes of strictly lower ``priority`` (their blocks swap out, their
scheduling state is kept in ``_suspended``) within the measured swap
bandwidth; suspended decodes resume, highest priority first, once a slot
and a full reservation are free.  A resumed decode commits the tokens an
unpreempted one would: its rows round-trip bitwise and sampling folds on
the request's ``(seed, count)``.

Sanitizers (``sanitize=True`` or ``MEGATRON_SANITIZE=1``,
``analysis/sanitizers.py``): the engine's locks and conditions record the
lock-order graph, the block ledger (pool and host tier) is audited every
iteration, and drain / shutdown leave a leak report in
``sanitizer_report``.  ``obs.logging.EVENT_LOG`` gets a line at each
request's lifecycle edge (submitted, admitted, first_token, finished,
preempted, resumed), all carrying its ``request_id``.

Device work goes through one seam, ``serving/device_ops.DeviceOps``: the
pool, every prefill piece, the publication of a prefill into pool blocks,
the decode and verify steps and copy-on-write's block copies are its
methods, called with host values.  A serving mesh (``mesh=``, built by
``serving/cluster/sharded.build_sharded_engine``) makes it the driver of
the mesh's other ranks: each call is also replayed on every rank over
its own shards, the engine running on rank 0 with its one host ledger.
Under a mesh with pp > 1 and a slot count that divides by pp, a decode
step runs the slots in pp contiguous groups (``_decode_groups``, JAX's
microbatch interleave), and ``kv_snapshot`` adds a ``stages`` section.
The host KV tier, a resident draft model, adapters and ``swap_params``
do not go through the seam and raise under a mesh.

Not in this slice, and refused at construction with ``NotImplementedError``
naming the ROADMAP item: disaggregated roles.  A model with
``quantize_matmuls="int8"`` (W8A8 training matmuls) is served on the
composed route, as in JAX: the fused decode step does not take it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..analysis import sanitizers
from ..config import ModelConfig
from ..generation.sampling import NEG_INF
from ..kernels.decode_step import (
    fused_paged_decode_eligible,
    fused_paged_verify_eligible,
)
from ..models import model as model_lib
from ..obs.logging import EVENT_LOG
from ..obs.trace import TraceRecorder, device_annotation
from ..ops.lora import slot_mask
from ..ops.quant import precision_route
from ..resilience.chaos import chaos
from .block_pool import BlockPool, HostKVTier
from .device_ops import DeviceOps, _sample_slots, _verify_step
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .queue import QueueFull, RequestQueue  # noqa: F401  (re-exported)
from .slots import SlotAllocator


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tuning knobs: every field and default of the JAX ``EngineConfig``
    (documented there and in docs/serving.md).  ``role`` must stay
    ``"mixed"``: see ``_refuse_unported``."""
    max_batch_size: int = 8
    max_seq_len: int = 1024
    max_queue_size: int = 32
    prefill_bucket: int = 1
    retry_after_s: float = 1.0
    idle_wait_s: float = 0.02
    pipeline_decode: bool = True
    prefill_chunk: Optional[int] = None
    default_deadline_s: Optional[float] = None
    prefix_cache_blocks: int = 256
    trace: bool = True
    trace_capacity: int = 8192
    kv_block_size: int = 0
    kv_pool_blocks: int = 0
    spec_draft_len: int = 0
    spec_ngram: int = 3
    spec_reprobe_interval: int = 16
    sanitize: bool = False
    adapter_cache_slots: int = 0
    host_kv_blocks: int = 0
    role: str = "mixed"


def check_engine_args(cfg: ModelConfig, ec: EngineConfig, *, mesh=None,
                      draft_cfg=None, adapters=None) -> None:
    """The engine's checks that need no device: a sequence budget past
    the model's positions, and ``_refuse_unported``.  Every rank of a
    sharded engine makes them first (``build_sharded_engine``), so a
    refusal raises everywhere and no rank waits on the others."""
    _refuse_unported(cfg, ec, mesh=mesh, draft_cfg=draft_cfg,
                     adapters=adapters)
    if ec.max_seq_len > cfg.max_position_embeddings:
        raise ValueError(
            f"max_seq_len {ec.max_seq_len} exceeds the model's "
            f"max_position_embeddings {cfg.max_position_embeddings}")


def _refuse_unported(cfg: ModelConfig, ec: EngineConfig, *, mesh,
                     draft_cfg=None, adapters=None) -> None:
    """Raise for every configuration this slice of the port does not run,
    rather than silently ignoring it: disaggregated roles, and under a
    serving mesh the options whose device work does not go through the
    ``DeviceOps`` seam."""
    sharded = mesh is not None and mesh.world_size > 1
    todo = [
        (ec.role != "mixed", f"role={ec.role!r}",
         "Queue 1 item 11 (c): disaggregated prefill/decode"),
        (sharded and ec.host_kv_blocks > 0, "the host KV tier under a mesh",
         "Queue 1 item 11 (a)'s remainder: the host tier sharded"),
        (sharded and draft_cfg is not None,
         "a resident draft model under a mesh",
         "Queue 1 item 11 (a)'s remainder: the draft model sharded"),
        (sharded and (adapters is not None or ec.adapter_cache_slots > 0),
         "adapters under a mesh",
         "Queue 1 item 11 (c): the cluster half of LoRA"),
        (sharded and cfg.num_experts > 0, "a MoE model under a mesh",
         "Queue 1 item 11 (a)'s remainder: MoE serving sharded"),
    ]
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"ServingEngine: {what} is not ported yet (ROADMAP.md, "
                f"{item})")


@dataclasses.dataclass
class FinishedRequest:
    tokens: List[int]             # prompt + generated (EOS included)
    prompt_len: int
    finish_reason: str            # "eos" | "length" | "cancelled" |
    #                               "timeout" | "error"
    logprobs: Optional[List[float]] = None  # [len-1] incl. prompt positions


class _Request:
    """Internal request record; the public face is ``RequestHandle``."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, prompt: Sequence[int], max_new_tokens: int, *,
                 eos_id: int = 2, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, seed: Optional[int] = None,
                 use_eos_stop: bool = True, return_logprobs: bool = False,
                 on_token: Optional[Callable[[int], None]] = None,
                 deadline_s: Optional[float] = None,
                 adapter_id: Optional[str] = None,
                 spec_force: bool = False,
                 priority: int = 0):
        self.id = next(self._ids)
        self.rid = f"req-{self.id}"
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.greedy = top_k == 0 and top_p == 0.0
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self.seed = int(seed) & 0xFFFFFFFF
        self.use_eos_stop = bool(use_eos_stop)
        self.return_logprobs = bool(return_logprobs)
        self.on_token = on_token
        self.adapter_id = adapter_id
        # warm-probe knob: draft even without an n-gram match (a wrong
        # draft is simply rejected), so a verify step runs on demand
        self.spec_force = bool(spec_force)
        self.priority = int(priority)
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.cancel_flag = threading.Event()
        self.done_event = threading.Event()
        self.result: Optional[FinishedRequest] = None
        self.submit_time = time.perf_counter()
        self.first_token_time: Optional[float] = None
        self.deadline: Optional[float] = (
            None if deadline_s is None
            else self.submit_time + float(deadline_s))


class RequestHandle:
    """Client-side view of a submitted request."""

    def __init__(self, req: _Request, engine: "ServingEngine"):
        self._req = req
        self._engine = engine

    @property
    def request_id(self) -> int:
        return self._req.id

    @property
    def rid(self) -> str:
        return self._req.rid

    def done(self) -> bool:
        return self._req.done_event.is_set()

    def cancel(self) -> None:
        """Drop the request at the next iteration boundary (or now, if it
        is still queued)."""
        self._engine._cancel(self._req)

    def result(self, timeout: Optional[float] = None) -> FinishedRequest:
        if not self._req.done_event.wait(timeout):
            raise TimeoutError(
                f"request {self._req.id} not finished within {timeout}s")
        if self._req.result.finish_reason == "error":
            raise RuntimeError(
                "serving engine scheduler failed: "
                f"{self._engine._scheduler_error!r}")
        return self._req.result


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


# speculative decoding policy: weight of the newest per-slot acceptance
# observation in the EWMA that scales the draft budget (the re-probe
# interval for collapsed slots is EngineConfig.spec_reprobe_interval)
_SPEC_EWMA_ALPHA = 0.3


def _ngram_draft_host(ctx: Sequence[int], ngram: int,
                      draft_len: int) -> List[int]:
    """Prompt-lookup draft: the tokens that followed the most recent
    EARLIER occurrence of the context's trailing ``ngram`` tokens, up to
    ``draft_len`` of them (possibly none).  Draft quality only moves
    throughput: any draft verifies exactly."""
    n = len(ctx)
    if draft_len < 1 or n < ngram + 1:
        return []
    a = np.asarray(ctx, np.int64)
    tail = a[-ngram:]
    # windows over a[:-1] so the trailing n-gram cannot match itself
    wins = np.lib.stride_tricks.sliding_window_view(a[:-1], ngram)
    hits = np.flatnonzero((wins == tail).all(axis=1))
    if hits.size == 0:
        return []
    j = int(hits[-1])
    return [int(t) for t in a[j + ngram:j + ngram + draft_len]]


# candidate branches the resident draft model surfaces per window position:
# branch 0 extends the main chain, branch 1 is the depth-1 hedge leaf
_DRAFT_TOPK = 2


def _draft_step(cfg: ModelConfig, params, k_pool, v_pool, tables, window,
                fills, bids, offs, *, rope, use_fused: bool) -> np.ndarray:
    """One resident-draft forward over the draft's shadow pool: a linear
    verify of each slot's window at its draft positions (K14 on the fused
    route), returning the top-2 candidates per position over the unpadded
    vocabulary, ``[S, W, 2]`` on the host.  Serves the absorb pass
    (committed tokens landing at real blocks) and the chain expansions
    (rows routed to the trash block).  Draft numbers never reach committed
    tokens: they only choose what the target verifies."""
    logits, _, _ = model_lib.forward_cached_paged_verify(
        cfg, params, window, k_pool, v_pool, tables, fills, bids, offs,
        rope=rope, use_fused=use_fused)
    pad = torch.arange(logits.shape[-1], device=logits.device) \
        >= cfg.vocab_size
    masked = logits.masked_fill(pad, NEG_INF)
    return torch.topk(masked, _DRAFT_TOPK, dim=-1).indices.cpu().numpy()


class _SlotState:
    """Host-side per-slot bookkeeping.  ``fill`` and ``count`` advance at
    dispatch; ``pending`` is the host copy of the slot's last sampled
    token, and ``fresh`` marks slots whose host value must override the
    device-resident token vector at the next dispatch."""

    def __init__(self, req: _Request, fill: int, pending: int):
        self.req = req
        self.fill = fill
        self.count = 1
        self.pending = pending
        self.fresh = True
        # the PrefixLease pinning the request's cached prefix blocks
        self.lease = None
        # acceptance EWMA scaling the slot's draft budget (1.0 at admission)
        # and the iterations it carried no draft (drives the re-probe)
        self.spec_ewma = 1.0
        self.spec_stall = 0
        # rows of the slot's context in the resident draft's shadow pool
        self.draft_fill = 0
        # the LoRA arena slot serving the request (-1: the base model)
        self.adapter_slot = -1


class _Suspended:
    """A decode preempted to the host tier: the live request, its host
    block ids in table order and the scheduling state (fill, the sampling
    fold count, the pending token, the speculation state) a bitwise
    resume rebuilds the slot from."""

    __slots__ = ("req", "hids", "n_live", "meta", "t_suspend")

    def __init__(self, req, hids, n_live, meta, t_suspend):
        self.req = req
        self.hids = hids
        self.n_live = n_live
        self.meta = meta
        self.t_suspend = t_suspend


class _PrefillState:
    """A chunked prefill in progress: the request holds a slot but is not
    decoding yet; its batch-1 working cache grows one chunk an
    iteration."""

    def __init__(self, req: _Request, slot: int, padded: int):
        self.req = req
        self.slot = slot
        self.padded = padded      # prompt rows to prefill, chunk-padded
        self.done = 0             # rows prefilled (a hit starts further)
        self.started = False      # its working cache (DeviceOps) exists
        self.lease = None         # the PrefixLease of a hit
        self.adapter_slot = -1    # pinned LoRA arena slot (-1: the base)


class _Inflight:
    """A dispatched-but-unprocessed decode step: device token vectors, the
    slot → state snapshot taken at dispatch (identity-checked at
    processing, so tokens of a slot that retired meanwhile are masked),
    and the pending host copies."""

    __slots__ = ("tok", "tok_lp", "host_tok", "host_lp", "ready", "slots",
                 "t_dispatch")

    def __init__(self, tok, tok_lp, slots, t_dispatch):
        self.tok = tok
        self.tok_lp = tok_lp
        self.slots = slots
        self.t_dispatch = t_dispatch
        if tok.is_cuda:  # start the host copies now; they overlap the next
            self.host_tok = torch.empty(tok.shape, dtype=tok.dtype,
                                        pin_memory=True)
            self.host_lp = torch.empty(tok_lp.shape, dtype=tok_lp.dtype,
                                       pin_memory=True)
            self.host_tok.copy_(tok, non_blocking=True)
            self.host_lp.copy_(tok_lp, non_blocking=True)
            self.ready = torch.cuda.Event()
            self.ready.record()
        else:
            self.host_tok, self.host_lp, self.ready = tok, tok_lp, None

    def fetch(self):
        """Wait for the host copies: ``(tok, tok_lp)`` numpy arrays."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.host_tok.numpy(), self.host_lp.numpy()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """Continuous-batching engine over a fixed set of KV slots.

    ``submit`` / ``submit_many`` are thread-safe and non-blocking (they
    raise ``QueueFull`` under backpressure); all device work happens on
    the scheduler thread.  ``device`` defaults to ``cuda``; pass ``"cpu"``
    to run the plain versions of the kernels (the tests do).

    ``draft_cfg``/``draft_params``: a resident draft model sharing the
    target's vocabulary (``models/families.draft_model``), engaged when
    ``spec_draft_len > 0``; its params live on the engine's device.
    ``adapters``: the ``serving.adapters.AdapterRegistry`` whose arena
    (on the engine's device) serves requests that name an adapter; it
    must have ``EngineConfig.adapter_cache_slots`` slots."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_config: Optional[EngineConfig] = None,
                 metrics: Optional[ServingMetrics] = None,
                 mesh=None, draft_cfg: Optional[ModelConfig] = None,
                 draft_params=None, adapters=None, device=None):
        self.cfg = cfg
        self.params = params
        self.config = engine_config or EngineConfig()
        check_engine_args(cfg, self.config, mesh=mesh, draft_cfg=draft_cfg,
                          adapters=adapters)
        if draft_cfg is not None:
            if draft_params is None:
                raise ValueError("draft_cfg requires draft_params")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: draft tokens must be verifiable")
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.device = model_lib.default_device(device)
        # the device seam: this rank's DeviceOps, or under a serving mesh
        # the driver that replays each call on the mesh's other ranks
        self.mesh = mesh
        self._sharded = mesh is not None and mesh.world_size > 1
        if not self._sharded:
            self._ops = DeviceOps(cfg, params, self.device, mesh)
        else:
            from .cluster.sharded import MeshDriver

            self._ops = MeshDriver(cfg, params, self.device, mesh)
        # slot groups of a decode step (pp on a pipelined mesh, start())
        self._decode_groups = 1
        # multi-tenant LoRA: the registry owns the arena; the engine pins
        # adapters at admission and passes the arena with a per-slot slot
        # vector to every step
        self.adapters = adapters
        if self.config.adapter_cache_slots and adapters is None:
            raise ValueError(
                "EngineConfig.adapter_cache_slots is set but no "
                "AdapterRegistry was passed to the engine")
        if adapters is not None:
            if (self.config.adapter_cache_slots
                    and adapters.n_slots != self.config.adapter_cache_slots):
                raise ValueError(
                    f"AdapterRegistry has {adapters.n_slots} arena slots "
                    f"but EngineConfig.adapter_cache_slots="
                    f"{self.config.adapter_cache_slots}")
            if adapters.device != self.device:
                raise ValueError(
                    f"AdapterRegistry's arena is on {adapters.device}, the "
                    f"engine runs on {self.device}")
            if adapters._metrics is None:
                # late-bound: a caller may replace the engine's metrics
                adapters._metrics = lambda: self.metrics
        # the weight precision route that tags every decode step
        self._precision_route = precision_route(params)
        # sanitizers first, so every lock the engine and its queue make
        # below is order-tracked
        self._sanitize = bool(self.config.sanitize) or sanitizers.env_enabled()
        if self._sanitize:
            sanitizers.enable_lock_tracking()
        self._sanitizer: Optional[sanitizers.LedgerSanitizer] = None
        self.sanitizer_report: List[dict] = []  # leaks found at drain
        self.metrics = metrics or ServingMetrics(self.config.max_batch_size)
        self.metrics.set_gauges(num_slots=self.config.max_batch_size)
        self.trace = TraceRecorder(capacity=self.config.trace_capacity,
                                   enabled=self.config.trace)
        self.queue = RequestQueue(self.config.max_queue_size,
                                  self.config.retry_after_s)
        self.slots: Optional[SlotAllocator] = None  # allocated on start
        self.prefix_cache: Optional[PrefixCache] = None  # built on start
        # tiered KV: the host tier is built at start(); ``_suspended`` maps
        # req.id -> _Suspended for decodes preempted to it, in order
        self.host_tier: Optional[HostKVTier] = None
        self._suspended: dict[int, _Suspended] = {}
        self._active: dict[int, _SlotState] = {}
        self._thread: Optional[threading.Thread] = None
        self._admitting: Optional[_Request] = None
        self._held: Optional[_Request] = None  # parked on pool pressure
        self._prefilling: Optional[_PrefillState] = None  # chunked prefill
        self._inflight: Optional[_Inflight] = None
        self._scheduler_error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._draining = threading.Event()
        self._lock = sanitizers.make_lock("engine.lifecycle")
        self._wake = sanitizers.make_condition("engine.wake")
        self._drain_cond = sanitizers.make_condition("engine.drain")
        self._last_dispatch_t: Optional[float] = None
        self._last_ready_t: Optional[float] = None
        # decode routes, resolved at start(): the fused whole-stack kernel
        # for plain steps (K13), for verify steps (K14, linear or tree) and
        # for the draft model's forwards
        self._fused_decode = False
        self._fused_verify = False
        self._fused_draft = False
        # the resident draft: engaged with speculation on; its shadow pool
        # (the target's block count and size, so the target's tables
        # address both) and RoPE tables are built at start()
        self._draft_enabled = (draft_cfg is not None
                               and self.config.spec_draft_len > 0)
        self._draft_kv = None
        self._draft_rope = None
        # control operations run on the scheduler thread between
        # iterations (``call_in_scheduler``)
        self._control: list = []
        self._control_lock = sanitizers.make_lock("engine.control")
        # set by start() and never cleared: a started engine whose thread
        # is gone is dead to the router's probe (``cluster.router``)
        self._started = threading.Event()
        # per-iteration scheduler heartbeat (perf_counter): the router's
        # probe reports its age; a thread wedged in a step stops it
        self.heartbeat: float = time.perf_counter()
        # the build's recipe (``cluster.sharded.build_sharded_engine`` /
        # ``build_cluster`` record it; the supervisor's rebuild reads it)
        self.rebuild_spec: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        with self._lock:
            if self._thread is None:
                if self.device.type == "cuda":
                    self._cuda_index = (
                        self.device.index if self.device.index is not None
                        else torch.cuda.current_device())
                ec = self.config
                # blocks follow the admission granularity by default, so
                # prefix-cache blocks are pool blocks
                bk = int(ec.kv_block_size or ec.prefill_chunk
                         or max(1, ec.prefill_bucket))
                bk = max(1, min(bk, ec.max_seq_len))
                table_blocks = -(-ec.max_seq_len // bk)
                n_blocks = int(ec.kv_pool_blocks) or (
                    1 + ec.max_batch_size * table_blocks
                    + ec.prefix_cache_blocks)
                pool = self._ops.start(n_blocks, bk, table_blocks * bk)
                pool.on_cow = lambda: self.metrics.inc("cow_copies_total")
                if self.mesh is not None:
                    pp = self.mesh.size("pp")
                    if pp > 1 and ec.max_batch_size % pp == 0:
                        self._decode_groups = pp
                self.slots = SlotAllocator(self.cfg, ec.max_batch_size,
                                           ec.max_seq_len, pool)
                if ec.host_kv_blocks:
                    self.host_tier = HostKVTier(
                        pool, ec.host_kv_blocks,
                        arity=self.slots.table_blocks,
                        metrics=lambda: self.metrics)
                if ec.prefix_cache_blocks:
                    self.prefix_cache = PrefixCache(
                        pool=pool, max_blocks=ec.prefix_cache_blocks,
                        metrics=lambda: self.metrics,
                        host_tier=self.host_tier)
                # the arena rides inside the fused kernels as an epilogue;
                # where a predicate declines its stacked rank, the
                # composed route applies the adapters (never dropped)
                lsr = 0 if self.adapters is None else self.adapters.sr
                self._fused_decode = fused_paged_decode_eligible(
                    self.cfg, self.params, pool.k_pool, ec.max_batch_size,
                    table_blocks, lsr, mesh=self.mesh)
                self._fused_verify = ec.spec_draft_len > 0 and \
                    fused_paged_verify_eligible(
                        self.cfg, self.params, pool.k_pool,
                        ec.max_batch_size, ec.spec_draft_len + 1,
                        table_blocks, lsr, mesh=self.mesh)
                if self._draft_enabled:
                    self._draft_kv = model_lib.init_kv_pool(
                        self.draft_cfg, n_blocks, bk, device=self.device)
                    self._draft_rope = model_lib.rope_tables(
                        self.draft_cfg, device=self.device)
                    self._fused_draft = fused_paged_verify_eligible(
                        self.draft_cfg, self.draft_params,
                        self._draft_kv[0], ec.max_batch_size,
                        ec.spec_draft_len + 1, table_blocks)
                self._update_pool_gauges()
                if self._sanitize:
                    self._sanitizer = sanitizers.LedgerSanitizer()
                self._thread = threading.Thread(
                    target=self._loop, name="serving-engine", daemon=True)
                self._started.set()
                self._thread.start()
        return self

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._thread is None:
                self._ops.close()  # a sharded engine's ranks stop here
                return
            self._stop.set()
            self.queue.notify()
            with self._wake:
                self._wake.notify_all()
            self._thread.join(timeout)
            self._thread = None
            with self._drain_cond:
                self._drain_cond.notify_all()
            if self._sanitizer is not None:
                self.sanitizer_report = self._sanitizer.leak_report(self)
                for leak in self.sanitizer_report:
                    EVENT_LOG.emit("sanitizer", "kv_block_leak", **leak)
            self._ops.close()

    def pause(self) -> None:
        """Stop admitting and decoding (requests keep queueing)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        with self._wake:
            self._wake.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting (submissions get ``QueueFull``), let everything in
        flight finish; True once idle, False on timeout."""
        self._draining.set()
        self.queue.notify()
        if self._thread is None:
            return True
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        with self._drain_cond:
            while True:
                idle = self._is_idle()
                if idle or self._stop.is_set():
                    if idle and self._sanitizer is not None:
                        self.sanitizer_report = (
                            self._sanitizer.leak_report(self))
                    return idle
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    return False
                self._drain_cond.wait(remaining)

    def _is_idle(self) -> bool:
        return (not self._active and self._admitting is None
                and self._prefilling is None and self._inflight is None
                and self._held is None and not self._suspended
                and len(self.queue) == 0)

    def _notify_drain(self) -> None:
        with self._drain_cond:
            self._drain_cond.notify_all()

    # -- submission (any thread) ------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_id: int = 2, temperature: float = 1.0, top_k: int = 0,
               top_p: float = 0.0, seed: Optional[int] = None,
               use_eos_stop: bool = True, return_logprobs: bool = False,
               on_token: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None,
               adapter_id: Optional[str] = None,
               spec_force: bool = False,
               priority: int = 0) -> RequestHandle:
        return self.submit_many([dict(
            prompt=prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            use_eos_stop=use_eos_stop, return_logprobs=return_logprobs,
            on_token=on_token, deadline_s=deadline_s,
            adapter_id=adapter_id, spec_force=spec_force,
            priority=priority)])[0]

    def submit_many(self, specs: Sequence[dict]) -> List[RequestHandle]:
        """Validate + enqueue a batch of requests all-or-nothing.  Raises
        ``ValueError`` for a request that can never fit and ``QueueFull``
        under backpressure."""
        self.start()
        if self._draining.is_set():
            self.metrics.inc("rejected_draining", by=len(specs))
            raise QueueFull(
                "engine is draining (shutting down); not accepting requests",
                retry_after_s=self.config.retry_after_s)
        reqs = []
        for spec in specs:
            spec = dict(spec)
            if spec.get("deadline_s") is None:
                spec["deadline_s"] = self.config.default_deadline_s
            req = _Request(**spec)
            if len(req.prompt) < 1:
                self.metrics.inc("rejected_invalid")
                raise ValueError("empty prompt")
            if req.max_new_tokens < 1:
                self.metrics.inc("rejected_invalid")
                raise ValueError("max_new_tokens must be >= 1")
            if len(req.prompt) + req.max_new_tokens > self.config.max_seq_len:
                self.metrics.inc("rejected_invalid")
                raise ValueError(
                    f"prompt ({len(req.prompt)} tokens) + max_new_tokens "
                    f"({req.max_new_tokens}) exceeds the per-slot sequence "
                    f"budget ({self.config.max_seq_len})")
            if req.adapter_id is not None:
                if self.adapters is None:
                    self.metrics.inc("rejected_invalid")
                    raise ValueError(
                        f"request names adapter {req.adapter_id!r} but "
                        "the engine has no adapter registry")
                if not self.adapters.known(req.adapter_id):
                    self.metrics.inc("rejected_invalid")
                    raise ValueError(
                        f"unknown adapter {req.adapter_id!r} (register "
                        "it before submitting)")
            pool = self.slots.pool
            need = -(-(len(req.prompt) + req.max_new_tokens)
                     // pool.block_size)
            if need > pool.usable_blocks:
                self.metrics.inc("rejected_invalid")
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{pool.usable_blocks} (kv_pool_blocks too small for "
                    f"this sequence budget)")
            reqs.append(req)
        try:
            self.queue.put_many(reqs)
        except QueueFull:
            self.metrics.inc("rejected_queue_full", by=len(reqs))
            raise
        self.metrics.inc("submitted", by=len(reqs))
        self.metrics.set_gauges(queue_depth=len(self.queue))
        for req in reqs:
            EVENT_LOG.emit("engine", "submitted", request_id=req.rid,
                           prompt_len=len(req.prompt),
                           max_new_tokens=req.max_new_tokens,
                           queue_depth=len(self.queue))
        return [RequestHandle(r, self) for r in reqs]

    def _cancel(self, req: _Request) -> None:
        req.cancel_flag.set()
        if self.queue.remove(req):  # still queued: finish it right here
            self._finish(req, "cancelled")
            self.metrics.set_gauges(queue_depth=len(self.queue))

    def call_in_scheduler(self, fn: Callable, timeout: float = 30.0):
        """Run ``fn()`` on the scheduler thread between iterations and
        return its result (its exception propagates to the caller).  From
        the scheduler thread itself it runs inline."""
        if threading.current_thread() is self._thread:
            return fn()
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError("engine scheduler is not running")
        box = {"done": threading.Event(), "result": None, "error": None}
        with self._control_lock:
            self._control.append((fn, box))
        self.queue.notify()
        with self._wake:
            self._wake.notify_all()
        if not box["done"].wait(timeout):
            raise TimeoutError(f"scheduler control op not run in {timeout}s")
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def _run_control_ops(self) -> None:
        with self._control_lock:
            ops, self._control = self._control, []
        for fn, box in ops:
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — the caller's
                box["error"] = e
            finally:
                box["done"].set()

    def swap_params(self, new_params):
        """Replace the base weights at an iteration boundary and return the
        old ones.  On the scheduler thread: the in-flight step, dispatched
        with the old weights, is processed first, so no token is lost or
        repeated; every later step runs the new weights.  The new tree must
        match the resident one's structure, shapes and dtypes (the routes
        resolved at ``start()`` carry over).  The LoRA arena is untouched:
        adapters compose with whichever base is resident.  Callable from
        any thread; before ``start()`` it swaps inline."""
        if self._sharded:
            raise NotImplementedError(
                "swap_params under a serving mesh is not ported yet "
                "(ROADMAP.md, Queue 1 item 11 (a)'s remainder)")
        if not _same_tree(self.params, new_params):
            raise ValueError(
                "swap_params needs a tree matching the resident params' "
                "structure, shapes and dtypes")

        def _swap():
            self._flush_inflight()
            old, self.params = self.params, new_params
            self._ops.params = new_params
            self._precision_route = precision_route(self.params)
            self.metrics.inc("param_swaps")
            return old

        if self._thread is None or not self._thread.is_alive():
            return _swap()
        return self.call_in_scheduler(_swap)

    # -- scheduler loop (engine thread only) -------------------------------

    def _loop(self) -> None:
        if self.device.type == "cuda":
            # a device without an index ("cuda", the server entry's
            # default) is the starting thread's current one
            torch.cuda.set_device(self._cuda_index)
        try:
            with torch.no_grad():
                while not self._stop.is_set():
                    self.heartbeat = time.perf_counter()
                    chaos().point("serve-step")
                    self._run_control_ops()
                    self._drain_cancellations()
                    self._expire_deadlines()
                    if self._paused.is_set():
                        self._flush_inflight()
                        self._last_dispatch_t = self._last_ready_t = None
                        with self._wake:
                            if (self._paused.is_set()
                                    and not self._stop.is_set()):
                                self._wake.wait(self.config.idle_wait_s)
                        continue
                    self._admit()
                    if self._active:
                        self._step()
                    elif self._inflight is not None:
                        # every slot retired while the step was in flight:
                        # its tokens are all speculative
                        self._flush_inflight()
                    elif self._prefilling is None:
                        if (self.host_tier is not None
                                and self.host_tier.in_flight):
                            # nothing to decode: land the swap backlog,
                            # then look at admission again (resumes)
                            self.host_tier.pump()
                            continue
                        self._last_dispatch_t = self._last_ready_t = None
                        self._notify_drain()
                        self.queue.wait_for_work(self.config.idle_wait_s)
                    if self._sanitizer is not None:
                        # the ledger audit, once an iteration; a
                        # LedgerError fails everything below, loudly
                        self._sanitizer.check_engine(self)
        except Exception as e:  # noqa: BLE001 — a dead scheduler must not
            # leave submitters blocked on result() forever
            logging.getLogger(__name__).exception(
                "serving engine scheduler died: %s", e)
            self._scheduler_error = e
            self._inflight = None
            self._ops.abort()
            if self._admitting is not None:
                self._finish(self._admitting, "error")
                self._admitting = None
            if self._prefilling is not None:
                self._finish(self._prefilling.req, "error")
                self._prefilling = None
            if self._held is not None:
                self._finish(self._held, "error")
                self._held = None
            for slot in list(self._active):
                req = self._active.pop(slot).req
                self._release_adapter(req)
                self._finish(req, "error")
            for key in list(self._suspended):
                sus = self._suspended.pop(key)
                if self.host_tier is not None:
                    self.host_tier.free(sus.hids)
                self._finish(sus.req, "error")
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                self._finish(req, "error")
            with self._control_lock:  # pending control ops: fail callers
                ops, self._control = self._control, []
            for _, box in ops:
                box["error"] = RuntimeError(
                    f"serving engine scheduler died: {e!r}")
                box["done"].set()
            self._stop.set()
            self._notify_drain()
        except BaseException as e:  # noqa: BLE001 — a hard crash
            # (chaos SimulatedCrash &c.) tears through cleanup the way
            # SIGKILL would: record it for the probes, then die WITHOUT
            # failing requests; they stay unfinished as after a real kill,
            # and the router's probe thread fails them over
            self._scheduler_error = e
            self._stop.set()

    def _drain_cancellations(self) -> None:
        for slot in [s for s, st in self._active.items()
                     if st.req.cancel_flag.is_set()]:
            self._retire(slot, "cancelled")
        if (self._prefilling is not None
                and self._prefilling.req.cancel_flag.is_set()):
            self._abort_prefill("cancelled")
        if self._held is not None and self._held.cancel_flag.is_set():
            req, self._held = self._held, None
            self._finish(req, "cancelled")
        for key in [k for k, sus in self._suspended.items()
                    if sus.req.cancel_flag.is_set()]:
            self._discard_suspended(key, "cancelled")

    def _abort_prefill(self, reason: str) -> None:
        ps, self._prefilling = self._prefilling, None
        if self.prefix_cache is not None:
            # unpin without offering: the slot holds a partial prefill
            self.prefix_cache.release(ps.lease)
        self._release_adapter(ps.req)
        self.slots.release(ps.slot)
        if ps.started:
            self._ops.drop(ps.req.id)
        self._finish(ps.req, reason)
        self.metrics.set_gauges(slots_active=self.slots.active_slots)

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()

        def expired(req: _Request) -> bool:
            return req.deadline is not None and now >= req.deadline

        for slot in [s for s, st in self._active.items() if expired(st.req)]:
            self._retire(slot, "timeout")
        if self._prefilling is not None and expired(self._prefilling.req):
            self._abort_prefill("timeout")
        if self._held is not None and expired(self._held):
            req, self._held = self._held, None
            self._finish(req, "timeout")
        for key in [k for k, sus in self._suspended.items()
                    if expired(sus.req)]:
            self._discard_suspended(key, "timeout")
        for req in self.queue.remove_if(expired):
            self._finish(req, "timeout")
        self.metrics.set_gauges(queue_depth=len(self.queue))

    def _next_admission(self) -> Optional[_Request]:
        """The parked request first (FIFO under pool pressure), else a
        fresh queue pop."""
        if self._held is not None:
            req, self._held = self._held, None
            return req
        req = self.queue.pop()
        if req is not None:
            # the request's ``queued`` span: submit -> scheduler pop
            self.trace.add("queued", req.submit_time, time.perf_counter(),
                           request_id=req.rid, tid=req.id,
                           args={"prompt_len": len(req.prompt)})
            self.metrics.set_gauges(queue_depth=len(self.queue))
        return req

    def _try_reserve(self, need: int,
                     req: Optional[_Request] = None) -> bool:
        """Reserve ``need`` pool blocks for the admission of ``req``.
        Under pool pressure: (1) squeeze the prefix cache's unpinned
        blocks (which spill to the host tier when there is one); (2) with
        a host tier, preempt active decodes of strictly lower priority to
        it, within its capacity and measured swap bandwidth.  Parking at
        the queue head is the caller's last resort."""
        pool = self.slots.pool
        if pool.reserve(need):
            return True
        if self.prefix_cache is not None:
            short = need - (pool.free_blocks - pool.reserved_blocks)
            if short > 0:
                self.prefix_cache.evict_blocks(short)
                self.metrics.set_gauges(
                    prefix_blocks=self.prefix_cache.blocks)
            if pool.reserve(need):
                return True
        if req is not None and self.host_tier is not None:
            while not pool.can_reserve(need):
                if not self.host_tier.swap_ok():
                    break  # the swap backlog is past the bandwidth bound
                victim = self._pick_preemption_victim(req.priority)
                if victim is None:
                    break
                before = len(self._active)
                if (not self._preempt_slot(victim)
                        and len(self._active) == before):
                    break  # no progress (a demote fault, a full tier)
            if pool.reserve(need):
                return True
        return False

    def _pick_preemption_victim(self, priority: int) -> Optional[int]:
        """The active decode to suspend for an admission of ``priority``:
        the lowest priority strictly below it, the oldest submission
        within a class, whose live blocks fit in the host tier."""
        best_key, best_slot = None, None
        for slot, st in self._active.items():
            if st.req.priority >= priority:
                continue
            if not self.host_tier.can_store(
                    len(self.slots.live_bids(slot))):
                continue
            key = (st.req.priority, st.req.submit_time)
            if best_key is None or key < best_key:
                best_key, best_slot = key, slot
        return best_slot

    def _admit(self) -> None:
        if self.host_tier is not None:
            self._maybe_resume()
        if self.config.prefill_chunk:
            self._admit_chunked()
            return
        while self.slots.free_slots:
            req = self._next_admission()
            if req is None:
                break
            if req.cancel_flag.is_set():
                self._finish(req, "cancelled")
                continue
            self._admitting = req
            admitted = self._prefill_into_slot(req)
            self._admitting = None
            if not admitted:  # parked in _held: pool pressure
                break
        self._update_pool_gauges()
        self.metrics.set_gauges(slots_active=self.slots.active_slots,
                                queue_depth=len(self.queue))

    def _admit_chunked(self) -> None:
        """Chunked admission: at most one prefill chunk an iteration, so
        the active streams get a decode step between chunks."""
        if self._prefilling is None and self.slots.free_slots:
            req = self._next_admission()
            while req is not None and req.cancel_flag.is_set():
                self._finish(req, "cancelled")
                req = self._next_admission()
            if req is not None:
                if req.return_logprobs:
                    # prompt logprobs need every prompt logit in one pass
                    self._admitting = req
                    self._prefill_into_slot(req)
                    self._admitting = None
                else:
                    self._begin_chunked_prefill(req)
        if self._prefilling is not None:
            self._advance_prefill()
        self._update_pool_gauges()
        self.metrics.set_gauges(slots_active=self.slots.active_slots,
                                queue_depth=len(self.queue))

    def _begin_chunked_prefill(self, req: _Request) -> None:
        """Claim a slot and a reservation for a chunked prefill (or park
        the request in ``_held``, nothing allocated).  A prefix hit's
        shared blocks are gathered into the working cache, and the chunk
        cursor starts at the last chunk start at or before the match."""
        claim = self._claim_slot(req)
        if claim is None:
            return
        slot, aslot, lease = claim
        chunk = max(1, int(self.config.prefill_chunk))
        padded = min(-(-len(req.prompt) // chunk) * chunk,
                     self.config.max_seq_len)
        ps = _PrefillState(req, slot, padded)
        ps.lease = lease
        ps.adapter_slot = aslot
        if lease is not None:
            # the shared rows past the last chunk start are recomputed
            # (to the same bits), so the chunks after it are the ones a
            # cold run of the prompt takes; the first chunk gathers the
            # shared blocks into the working cache
            ps.done = lease.tokens // chunk * chunk
        self._prefilling = ps

    def _advance_prefill(self) -> None:
        """Run the next chunk of the prefill in progress; after the last,
        publish the working cache into the slot and sample the first
        token."""
        ps = self._prefilling
        req = ps.req
        chunk = max(1, int(self.config.prefill_chunk))
        t = self.metrics.timers("serving-prefill")
        t.start()
        off = ps.done
        c = min(chunk, ps.padded - off)
        tokens = np.zeros((1, c), np.int64)
        seg = req.prompt[off:off + c]  # shorter than c at the padded tail
        tokens[0, :len(seg)] = seg
        last = off + c >= ps.padded
        with self.trace.span(f"prefill_chunk[{off // chunk}]",
                             request_id=req.rid, tid=req.id, annotate=True,
                             device=self.device,
                             args={"off": off, "tokens": c}):
            # the first chunk attends only itself (the flash kernel); a
            # later one attends the working cache at its offset
            logits = self._ops.prefill(
                req.id, tokens, off, fresh=not ps.started,
                table=(self._lease_table(ps.lease)
                       if not ps.started and ps.lease is not None else None),
                rows=len(req.prompt) - 1 - off if last else "last",
                lora=self._lora([ps.adapter_slot]))
        ps.started = True
        ps.done = off + c
        self.metrics.inc("prefill_chunks")
        if not last:
            t.stop()
            return
        # the chunk-padded tail rows hold pad-token K/V that the slot's
        # fill masks
        self._prefilling = None
        self._ops.publish(req.id, self.slots.claim_blocks(
            ps.slot, len(req.prompt),
            ps.lease.bids if ps.lease is not None else ()))
        tok, tok_lp = _sample_slots(
            logits[:, 0], [req.seed], [0], [req.greedy], [req.temperature],
            [req.top_k], [req.top_p], self.cfg.vocab_size)
        first = int(tok[0])
        first_lp = float(tok_lp[0])
        t.stop()
        self.metrics.inc("admitted")
        self.metrics.inc("prefills")
        EVENT_LOG.emit("engine", "admitted", request_id=req.rid,
                       slot=ps.slot, prompt_len=len(req.prompt),
                       cached_tokens=ps.lease.tokens if ps.lease else 0,
                       chunked=True)
        st = _SlotState(req, fill=len(req.prompt), pending=first)
        st.lease = ps.lease
        st.adapter_slot = ps.adapter_slot
        self._active[ps.slot] = st
        if self._draft_enabled:
            self._draft_prefill(ps.slot, st)
        self._commit_token(ps.slot, first, first_lp)

    def _lease_table(self, lease) -> np.ndarray:
        """The ``[1, T]`` table that gathers a lease's shared blocks into a
        working cache (trash past the match)."""
        table = np.zeros((1, self.slots.table_blocks), np.int64)
        table[0, :len(lease.bids)] = lease.bids
        return table

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device tensor (``DeviceOps.tensor``)."""
        return self._ops.tensor(a)

    @property
    def _rope(self):
        return self._ops.rope

    def _acquire_adapter(self, req: _Request) -> Optional[int]:
        """Pin the request's adapter in the arena: its arena slot (-1 for a
        base-model request), or None when every arena slot is pinned by
        other requests (the caller parks the request)."""
        if req.adapter_id is None:
            return -1
        return self.adapters.acquire(req.adapter_id)

    def _release_adapter(self, req: _Request) -> None:
        if req.adapter_id is not None and self.adapters is not None:
            self.adapters.release(req.adapter_id)

    def _lora(self, aslots):
        """The ``(arenas, mask)`` operand of a step whose rows sit at arena
        slots ``aslots`` (-1: the base model): the mask is built on the
        device from the slot vector.  None without a registry."""
        if self.adapters is None:
            return None
        slots = self._tensor(np.asarray(aslots, np.int64))
        return self.adapters.arenas, slot_mask(
            slots, self.adapters.n_slots, self.adapters.rank)

    def _prefill(self, tokens: np.ndarray, plen: int, want_logprobs: bool,
                 lora=None, key=None):
        """Prefill one request (batch 1, bucket-padded) into a fresh dense
        working cache ``[L, 1, kv, width, d]`` (``DeviceOps`` key ``key``):
        ``(last_logits [1, V], picked prompt logprobs or None, k, v)``.
        Rows past ``plen`` hold pad-token K/V that the slot's fill masks."""
        tokens = tokens.astype(np.int64)
        logits = self._ops.prefill(key, tokens, 0, fresh=True,
                                   rows=None if want_logprobs else plen - 1,
                                   lora=lora)
        k, v = self._ops.work(key)
        if want_logprobs:
            lp = torch.log_softmax(logits, dim=-1)
            toks = self._tensor(tokens)
            picked = torch.gather(lp[:, :-1], 2, toks[:, 1:, None])[..., 0]
            return logits[:, plen - 1], picked, k, v
        return logits[:, 0], None, k, v

    def _prefill_piece(self, tokens: Sequence[int], k, v, off: int,
                       draft: bool = False):
        """Prefill ``tokens`` (bucket-padded) at positions ``off ..`` into
        the batch-1 view ``k``/``v``, attending the rows before ``off``:
        one ``forward_cached`` (``empty_cache`` at offset 0) of the target,
        or with ``draft`` of the resident draft model.  → ``(logits [1, V]
        of the last token, k, v)``."""
        cfg, params, rope = ((self.draft_cfg, self.draft_params,
                              self._draft_rope) if draft
                             else (self.cfg, self.params, self._rope))
        n = len(tokens)
        toks = self._piece_tokens(tokens, off)
        logits, k, v = model_lib.forward_cached(
            cfg, params, self._tensor(toks), k, v, off, rope=rope,
            empty_cache=off == 0, logit_rows=torch.tensor([n - 1]))
        return logits[:, 0], k, v

    def _piece_tokens(self, tokens: Sequence[int], off: int) -> np.ndarray:
        """A prefill piece's ``[1, w]`` tokens, padded to the bucket (never
        past the slot's sequence budget)."""
        n = len(tokens)
        bucket = max(1, self.config.prefill_bucket)
        width = min(-(-n // bucket) * bucket, self.config.max_seq_len - off)
        toks = np.zeros((1, width), np.int64)
        toks[0, :n] = tokens
        return toks

    def _split(self, plen: int) -> int:
        """Where a prompt's last prefill piece starts with the prefix cache
        on: its last whole block before the last token (the longest match
        it allows), 0 with the cache off.  A MoE model's cold prefill is
        one piece, as JAX's is: its routing groups span the piece, so two
        pieces would route the prompt's tokens in other groups."""
        if self.prefix_cache is None or self.cfg.num_experts > 0:
            return 0
        bk = self.slots.pool.block_size
        return (plen - 1) // bk * bk

    def _prefill_cached(self, req: _Request, lease, key=None):
        """Admission prefill with the prefix cache on: the rows a hit
        shares come from the lease's blocks, gathered into a batch-1 view
        (trash past the match), and the rest of the prompt is prefilled in
        at most two pieces split at the longest match the prompt allows
        (``split``, its last whole block before the last token): ``[done,
        split)`` and ``[split, plen)``.  So the last piece of a cold run,
        and of any hit, attends the same rows the same way, and a repeat
        of a prompt (whose match is ``split``) commits the cold run's
        tokens bit for bit, in bf16 too; a single cold pass would give
        the repeat other roundings.  A hit's suffix attends the shared
        rows through the masked dense path (JAX's ``_prefill_chunk_impl``
        with ``first=False``).  → ``(last_logits [1, V], k, v)``."""
        split = self._split(len(req.prompt))
        done = lease.tokens if lease is not None else 0
        table = self._lease_table(lease) if lease is not None else None
        pieces = ([(done, split)] if done < split else []) + \
            [(split, len(req.prompt))]
        for i, (lo, hi) in enumerate(pieces):
            logits = self._ops.prefill(
                key, self._piece_tokens(req.prompt[lo:hi], lo), lo,
                fresh=i == 0, table=table, rows=hi - lo - 1)
        k, v = self._ops.work(key)
        return logits[:, 0], k, v

    def _shares_prefix(self, req: _Request) -> bool:
        """Whether a request matches and seeds the prefix cache: not one
        that wants prompt logprobs (every prompt logit, from a cold
        prefill), nor an adapter request (its K/V rows carry the
        adapter's deltas)."""
        return (self.prefix_cache is not None and not req.return_logprobs
                and req.adapter_id is None)

    def _claim_slot(self, req: _Request):
        """A slot, the request's arena slot and its prefix lease, with the
        pool's reservation for the rest of its worst case: ``(slot,
        aslot, lease)``; None (the request parked in ``_held``, nothing
        held) when the arena or the pool cannot take it now."""
        slot = self.slots.alloc()
        aslot = self._acquire_adapter(req)
        if aslot is None:
            self.slots.release(slot)
            self._held = req
            return None
        lease = None
        if self._shares_prefix(req):
            t_pm = time.perf_counter()
            lease = self.prefix_cache.match_and_acquire(req.prompt)
            self.trace.add(
                "prefix_match", t_pm, time.perf_counter(),
                request_id=req.rid, tid=req.id,
                args={"hit": lease is not None,
                      "matched_tokens": lease.tokens if lease else 0})
        n_shared = len(lease.bids) if lease is not None else 0
        need = (-(-(len(req.prompt) + req.max_new_tokens)
                  // self.slots.pool.block_size) - n_shared)
        if not self._try_reserve(need, req):
            if self.prefix_cache is not None:
                self.prefix_cache.release(lease)
            self._release_adapter(req)
            self.slots.release(slot)
            self._held = req
            return None
        self.slots.set_reservation(slot, need)
        return slot, aslot, lease

    def _prefill_into_slot(self, req: _Request) -> bool:
        """Whole-prompt admission.  False (request parked in ``_held``,
        nothing allocated) when the pool cannot reserve the request's
        worst-case block count, or every arena slot is pinned by other
        adapters.  Requests that want prompt logprobs take the cold
        prefill (they need every prompt logit) and skip the prefix cache;
        so do adapter requests, whose K/V rows carry their adapter's
        deltas and must not be shared."""
        claim = self._claim_slot(req)
        if claim is None:
            return False
        slot, aslot, lease = claim
        plen = len(req.prompt)
        bucket = max(1, self.config.prefill_bucket)
        cached = self._shares_prefix(req)
        t = self.metrics.timers("serving-prefill")
        t.start()
        t_pf = time.perf_counter()
        with device_annotation("prefill", self.device):
            if cached:
                last_logits, _, _ = self._prefill_cached(req, lease,
                                                         key=req.id)
            else:
                padded = min(-(-plen // bucket) * bucket,
                             self.config.max_seq_len)
                tokens = np.zeros((1, padded), np.int64)
                tokens[0, :plen] = req.prompt
                last_logits, picked, _, _ = self._prefill(
                    tokens, plen, req.return_logprobs,
                    lora=self._lora([aslot]), key=req.id)
                if req.return_logprobs:
                    req.logprobs.extend(picked[0, :plen - 1].cpu().tolist())
        self._ops.publish(req.id, self.slots.claim_blocks(
            slot, plen, lease.bids if lease is not None else ()))
        # first generated token: the decode step's per-request sampling rule
        tok, tok_lp = _sample_slots(
            last_logits, [req.seed], [0], [req.greedy], [req.temperature],
            [req.top_k], [req.top_p], self.cfg.vocab_size)
        first = int(tok[0])
        first_lp = float(tok_lp[0])
        t.stop()
        self.trace.add("prefill", t_pf, time.perf_counter(),
                       request_id=req.rid, tid=req.id,
                       args={"prompt_len": plen,
                             "cached_tokens": lease.tokens if lease else 0})
        self.metrics.inc("admitted")
        self.metrics.inc("prefills")
        EVENT_LOG.emit("engine", "admitted", request_id=req.rid, slot=slot,
                       prompt_len=plen,
                       cached_tokens=lease.tokens if lease else 0,
                       chunked=False)
        st = _SlotState(req, fill=plen, pending=first)
        st.lease = lease
        st.adapter_slot = aslot
        self._active[slot] = st
        if self._draft_enabled:
            self._draft_prefill(slot, st)
        self._commit_token(slot, first, first_lp)
        return True

    def _draft_prefill(self, slot: int, st: _SlotState) -> None:
        """Absorb a slot's context into the draft's shadow pool with a
        dense prefill in the pieces a cold target prefill takes (so a
        self-draft's rows are the target's), published at the slot's
        table; the pending token and later commits are absorbed by the
        tree steps.  Blocks shared through the prefix cache get their
        draft rows rewritten from the same tokens; after a target-side
        copy-on-write the new block's older draft rows are stale.  Both
        only move which tokens the target verifies, never what commits."""
        ctx = st.req.prompt + st.req.generated
        n = min(st.fill, len(ctx))
        split = self._split(n)
        with self.trace.span("draft_prefill", request_id=st.req.rid,
                             tid=st.req.id, annotate=True,
                             device=self.device, args={"tokens": n}):
            k, v = model_lib.init_kv_cache(self.draft_cfg, 1,
                                           self.slots.width,
                                           device=self.device)
            if split:
                _, k, v = self._prefill_piece(ctx[:split], k, v, 0,
                                              draft=True)
            _, k, v = self._prefill_piece(ctx[split:n], k, v, split,
                                          draft=True)
            dk, dv = self._draft_kv
            bids = self.slots.tables[slot].astype(np.int64)
            model_lib.cache_scatter_blocks(dk, k, self._tensor(bids))
            model_lib.cache_scatter_blocks(dv, v, self._tensor(bids))
        st.draft_fill = n

    def _step(self) -> None:
        """One decode iteration: dispatch step N+1, then process step N's
        tokens (computed, and streaming back, meanwhile).  Without
        ``pipeline_decode`` the same step is dispatched and processed.

        With speculative decoding on, an iteration where some slot can
        carry a draft takes a verify step instead: the pipeline is flushed
        (drafts match against committed context, and the next fill depends
        on how many land) and up to ``spec_draft_len + 1`` tokens commit
        per slot."""
        if self.config.spec_draft_len > 0 and self._plan_spec():
            self._flush_inflight()
            if self._draft_enabled:
                plans = self._plan_tree_budgets()
                if plans:
                    self._spec_step_tree(plans)
                    return
            else:
                drafts = self._build_drafts()
                if drafts:
                    self._spec_step(drafts)
                    return
        it0 = time.perf_counter()
        t = self.metrics.timers("serving-decode")
        t.start()
        inflight = self._dispatch_decode()
        prev, self._inflight = self._inflight, inflight
        if self.host_tier is not None and self.host_tier.in_flight:
            # the host phase of the pipelined step: land at most one
            # finished demote while the card runs the dispatch
            self.host_tier.pump(max_swaps=1)
        wait_s = 0.0
        if prev is not None:
            wait_s += self._process_step_results(prev)
        if not self.config.pipeline_decode:
            cur, self._inflight = self._inflight, None
            wait_s += self._process_step_results(cur)
        t.stop()
        host_s = max(0.0, (time.perf_counter() - it0) - wait_s)
        self.metrics.observe_step_breakdown(host_s=host_s)
        self.metrics.set_gauges(slots_active=self.slots.active_slots)
        self.trace.add(
            "engine_step", it0, time.perf_counter(), tid=0,
            args={"batch": len(inflight.slots),
                  "route": "fused" if self._fused_decode else "fallback",
                  "pipelined": self.config.pipeline_decode})

    def _dispatch_decode(self) -> _Inflight:
        S = self.config.max_batch_size
        overrides = np.zeros((S,), np.int64)
        override_mask = np.zeros((S,), bool)
        fills = np.zeros((S,), np.int64)
        seeds = np.zeros((S,), np.int64)
        counters = np.zeros((S,), np.int64)
        greedy = np.ones((S,), bool)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int64)
        top_ps = np.zeros((S,), np.float32)
        aslots = np.full((S,), -1, np.int64)  # -1 rows: no LoRA delta
        for slot, st in self._active.items():
            fills[slot] = st.fill
            aslots[slot] = st.adapter_slot
            seeds[slot] = st.req.seed
            counters[slot] = st.count
            greedy[slot] = st.req.greedy
            temps[slot] = st.req.temperature
            top_ks[slot] = st.req.top_k
            top_ps[slot] = st.req.top_p
            overrides[slot] = st.pending
            if st.fresh:
                override_mask[slot] = True
                st.fresh = False
            # lazy paged growth: the block receiving this step's row must
            # exist before the tables are snapshotted (reservation-backed)
            self.slots.append_block_id(slot, st.fill)

        t0 = time.perf_counter()
        if self._last_dispatch_t is not None:
            wall = t0 - self._last_dispatch_t
            if wall > 0:
                gap = (0.0 if self._inflight is not None
                       or self._last_ready_t is None
                       else min(wall, t0 - self._last_ready_t))
                self.metrics.observe_step_breakdown(gap_frac=gap / wall)
        self._last_dispatch_t = t0

        self.metrics.inc_step(self._fused_decode, self._precision_route)
        with device_annotation("decode", self.device):
            # without a step in flight every pending value is host-known;
            # else the previous step's tokens feed this one on the device
            # (a fresh slot's override in its row)
            tok, tok_lp = self._ops.decode(
                self.slots.tables.astype(np.int64), fills, overrides,
                override_mask, self._inflight is not None, seeds, counters,
                greedy, temps, top_ks, top_ps, groups=self._decode_groups,
                use_fused=self._fused_decode, lora=self._lora(aslots))
        snapshot = dict(self._active)
        for st in snapshot.values():
            st.fill += 1   # the fed token's K/V row lands this step
            st.count += 1  # one more token sampled (possibly speculative)
        return _Inflight(tok, tok_lp, snapshot, t0)

    def _process_step_results(self, step: _Inflight) -> float:
        """Bring a dispatched step's tokens to the host and commit them.
        Returns the wall time spent waiting on the device."""
        t_fetch = time.perf_counter()
        tok, tok_lp = step.fetch()
        t_ready = time.perf_counter()
        self._last_ready_t = t_ready
        committed = 0
        for slot, st in step.slots.items():
            if self._active.get(slot) is not st:
                # retired or re-admitted since dispatch: the token is
                # speculative — masked, never committed
                continue
            committed += 1
            st.pending = int(tok[slot])
            st.fresh = self._inflight is None
            if self.trace.enabled:
                self.trace.add("decode", step.t_dispatch, t_ready,
                               request_id=st.req.rid, tid=st.req.id,
                               args={"slot": slot,
                                     "token_index": len(st.req.generated)})
            self._commit_token(slot, st.pending, float(tok_lp[slot]))
        device_s = t_ready - step.t_dispatch
        self.metrics.observe_decode_iteration(committed, device_s)
        self.metrics.observe_step_breakdown(device_s=device_s)
        return t_ready - t_fetch

    def _flush_inflight(self) -> None:
        """Drain the in-flight step (pause/idle paths); a step whose slots
        all retired is dropped without syncing."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            return
        if any(self._active.get(s) is st for s, st in prev.slots.items()):
            self._process_step_results(prev)

    # -- speculative decoding ---------------------------------------------

    def _spec_budget(self, st: _SlotState) -> int:
        """Draft tokens for a slot, from its acceptance EWMA; a slot the
        policy collapsed to zero re-probes with one token every
        ``spec_reprobe_interval`` iterations."""
        k = int(round(st.spec_ewma * self.config.spec_draft_len))
        if k < 1:
            return (1 if st.spec_stall >= self.config.spec_reprobe_interval
                    else 0)
        return k

    def _plan_spec(self) -> bool:
        """The per-iteration gate, run BEFORE breaking the decode pipeline:
        stall bookkeeping and an n-gram probe on the host context (which
        lacks at most the one in-flight token), so the engine only pays a
        flush when some slot can plausibly carry a draft."""
        if not self._active:
            return False
        W = self.config.spec_draft_len + 1
        if any(st.fill + W > self.slots.width
               for st in self._active.values()):
            # a verify step writes (masked) rows at fill .. fill + W - 1 of
            # every rider: near a slot's table end the batch takes plain
            # steps, at most W iterations per request
            return False
        want = False
        for st in self._active.values():
            if not st.req.greedy or st.count > st.req.max_new_tokens - 2:
                continue
            if not st.req.spec_force and self._spec_budget(st) < 1:
                st.spec_stall += 1
                continue
            # a resident draft model always has something to propose
            if self._draft_enabled or st.req.spec_force or \
                    _ngram_draft_host(st.req.prompt + st.req.generated,
                                      self.config.spec_ngram, 1):
                want = True
            else:
                st.spec_stall += 1
        return want

    def _build_drafts(self) -> dict:
        """slot -> draft tokens for this verify step, on fully committed
        contexts (the pipeline is flushed)."""
        drafts = {}
        for slot, st in self._active.items():
            if not st.req.greedy:
                continue
            rem = st.req.max_new_tokens - len(st.req.generated)
            budget = (self.config.spec_draft_len if st.req.spec_force
                      else self._spec_budget(st))
            k_cap = min(self.config.spec_draft_len, budget, rem - 1)
            if k_cap < 1:
                continue
            ctx = st.req.prompt + st.req.generated
            d = _ngram_draft_host(ctx, self.config.spec_ngram, k_cap)
            if not d and st.req.spec_force:
                # no organic match: repeat the last token.  Almost surely
                # rejected, but verify commits the right token anyway
                d = [int(ctx[-1])] * k_cap
            if d:
                drafts[slot] = d
                st.spec_stall = 0
        return drafts

    def _spec_step(self, drafts: dict) -> None:
        """One verify iteration (pipeline flushed): feed every slot's
        ``[pending, draft...]`` window, accept the longest draft prefix
        that greedy decoding would have produced, commit it and the next
        token, and roll the rest back by not advancing ``fill`` past them
        (the rejected rows sit past the fill, masked, and are overwritten
        later)."""
        it0 = time.perf_counter()
        t = self.metrics.timers("serving-decode")
        t.start()
        S = self.config.max_batch_size
        W = self.config.spec_draft_len + 1
        window = np.zeros((S, W), np.int64)
        fills = np.zeros((S,), np.int64)
        seeds = np.zeros((S,), np.int64)
        counters = np.zeros((S,), np.int64)
        greedy = np.ones((S,), bool)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int64)
        top_ps = np.zeros((S,), np.float32)
        bids = np.zeros((S * W,), np.int64)   # default: the trash block
        offs = np.zeros((S * W,), np.int64)
        aslots = np.full((S,), -1, np.int64)
        bk = self.slots.pool.block_size
        for slot, st in self._active.items():
            d = drafts.get(slot, ())
            aslots[slot] = st.adapter_slot
            window[slot, 0] = st.pending
            window[slot, 1:1 + len(d)] = d
            fills[slot] = st.fill
            seeds[slot] = st.req.seed
            counters[slot] = st.count
            greedy[slot] = st.req.greedy
            temps[slot] = st.req.temperature
            top_ks[slot] = st.req.top_k
            top_ps[slot] = st.req.top_p
            st.fresh = False
            # the rows that may commit get their blocks before the tables
            # are read; rows past the draft go to the trash block
            for j in range(len(d) + 1):
                pos = st.fill + j
                bids[slot * W + j] = self.slots.append_block_id(slot, pos)
                offs[slot * W + j] = pos % bk
        t0 = time.perf_counter()
        if self._last_dispatch_t is not None:
            wall = t0 - self._last_dispatch_t
            if wall > 0 and self._last_ready_t is not None:
                gap = min(wall, t0 - self._last_ready_t)
                self.metrics.observe_step_breakdown(gap_frac=gap / wall)
        self._last_dispatch_t = t0
        self.metrics.inc_step(self._fused_verify, self._precision_route)
        with device_annotation("verify", self.device):
            g_tok, g_lp = self._ops.verify(
                self.slots.tables.astype(np.int64), window, fills, bids,
                offs, seeds, counters, greedy, temps, top_ks, top_ps,
                use_fused=self._fused_verify, lora=self._lora(aslots))
            # synchronous by design: the next fills depend on the
            # acceptances
            g_tok, g_lp = g_tok.cpu().numpy(), g_lp.cpu().numpy()
        t_ready = time.perf_counter()
        self._last_ready_t = t_ready
        device_s = t_ready - t0
        total_committed = proposed = accepted_total = 0
        per_slot_committed = []
        slot_ewmas = {}
        for slot, st in list(self._active.items()):
            d = drafts.get(slot, ())
            acc = 0
            while acc < len(d) and int(g_tok[slot, acc]) == d[acc]:
                acc += 1
            proposed += len(d)
            accepted_total += acc
            if d:
                st.spec_ewma = ((1.0 - _SPEC_EWMA_ALPHA) * st.spec_ewma
                                + _SPEC_EWMA_ALPHA * acc / len(d))
                slot_ewmas[slot] = st.spec_ewma
            # rows of the pending token and the accepted drafts landed; the
            # next token's row is the next step's write
            st.fill += acc + 1
            st.count += acc + 1
            st.fresh = True
            committed_here = 0
            for j in range(acc + 1):
                if self._active.get(slot) is not st:
                    break  # EOS / budget retired the slot mid-window
                st.pending = int(g_tok[slot, j])
                committed_here += 1
                self._commit_token(slot, st.pending, float(g_lp[slot, j]))
            total_committed += committed_here
            if d:
                per_slot_committed.append(committed_here)
            if self.trace.enabled:
                self.trace.add("decode", t0, t_ready,
                               request_id=st.req.rid, tid=st.req.id,
                               args={"slot": slot, "spec": True,
                                     "proposed": len(d), "accepted": acc,
                                     "committed": committed_here})
        t.stop()
        self.metrics.observe_spec_step(proposed, accepted_total,
                                       per_slot_committed, source="ngram",
                                       slot_ewmas=slot_ewmas)
        self.metrics.observe_decode_iteration(total_committed, device_s)
        self.metrics.observe_step_breakdown(device_s=device_s)
        host_s = max(0.0, (time.perf_counter() - it0) - device_s)
        self.metrics.observe_step_breakdown(host_s=host_s)
        self.metrics.set_gauges(slots_active=self.slots.active_slots)
        self.trace.add(
            "engine_step", it0, time.perf_counter(), tid=0,
            args={"batch": len(drafts),
                  "route": ("spec_fused" if self._fused_verify
                            else "spec_fallback"),
                  "pipelined": False, "proposed": proposed,
                  "accepted": accepted_total})

    # -- resident draft model: candidate trees ------------------------------

    def _plan_tree_budgets(self) -> dict:
        """slot -> draft-token budget (tree nodes less the root) for this
        tree step, on fully committed contexts (the pipeline is flushed)."""
        plans = {}
        for slot, st in self._active.items():
            if not st.req.greedy:
                continue
            rem = st.req.max_new_tokens - len(st.req.generated)
            k_cap = min(self.config.spec_draft_len, self._spec_budget(st),
                        rem - 1)
            if k_cap < 1:
                continue
            plans[slot] = k_cap
            st.spec_stall = 0
        return plans

    def _draft_forward(self, window, fills, bids, offs, tables):
        """``_draft_step`` on the draft's stack and shadow pool."""
        dk, dv = self._draft_kv
        return _draft_step(self.draft_cfg, self.draft_params, dk, dv, tables,
                           self._tensor(window), self._tensor(fills),
                           self._tensor(bids), self._tensor(offs),
                           rope=self._draft_rope,
                           use_fused=self._fused_draft)

    def _draft_absorb(self, plans: dict, tables) -> dict:
        """Catch each planned slot's draft rows up to ``fill + 1`` (its
        context and pending token) in W-token chunks, landing at their
        real positions through the target's tables, and return slot ->
        the draft's top-2 continuations of the pending token.  In steady
        speculation a slot is ``acc + 1 <= W`` rows behind: one forward."""
        S = self.config.max_batch_size
        W = self.config.spec_draft_len + 1
        bk = self.slots.pool.block_size
        heads = {}
        while True:
            window = np.zeros((S, W), np.int64)
            fills_d = np.zeros((S,), np.int64)
            bids_d = np.zeros((S * W,), np.int64)   # default: trash
            offs_d = np.zeros((S * W,), np.int64)
            finishing = []
            pending_work = False
            for slot, st in self._active.items():
                if slot not in plans:
                    continue
                seq = st.req.prompt + st.req.generated
                lo = st.draft_fill
                hi = min(st.fill + 1, lo + W)
                fills_d[slot] = lo
                if hi <= lo:
                    continue
                n = hi - lo
                window[slot, :n] = seq[lo:hi]
                for j in range(n):
                    pos = lo + j
                    bids_d[slot * W + j] = self.slots.tables[slot][pos // bk]
                    offs_d[slot * W + j] = pos % bk
                st.draft_fill = hi
                if hi == st.fill + 1:
                    finishing.append((slot, n))
                else:
                    pending_work = True
            if not finishing and not pending_work:
                break
            with self.trace.span("draft_absorb", annotate=True,
                                 device=self.device,
                                 args={"slots": len(finishing)}):
                cand = self._draft_forward(window, fills_d, bids_d, offs_d,
                                           tables)
            for slot, n in finishing:
                heads[slot] = cand[slot, n - 1].tolist()
        return heads

    def _draft_expand(self, chains: dict, tables) -> None:
        """Grow each planned slot's main chain to its budgeted length by
        draft forwards over the chain so far at ``fill + 1``, every row to
        the trash block: the in-window splice makes depth >= 2 exact with
        no shadow-pool write, so a rejected chain leaves nothing behind.
        The window is cut to the chain's length, which keeps every
        position inside the slot's table.  ``chains``: slot -> (tokens,
        target length), grown in place."""
        S = self.config.max_batch_size
        W = self.config.spec_draft_len + 1
        for depth in range(1, W - 1):
            window = np.zeros((S, depth), np.int64)
            fills_d = np.zeros((S,), np.int64)
            growing = []
            for slot, (chain, want) in chains.items():
                if len(chain) != depth or len(chain) >= want:
                    continue
                window[slot] = chain
                fills_d[slot] = self._active[slot].fill + 1
                growing.append(slot)
            if not growing:
                break
            trash = np.zeros((S * depth,), np.int64)
            with self.trace.span("draft_expand", annotate=True,
                                 device=self.device,
                                 args={"depth": depth,
                                       "slots": len(growing)}):
                cand = self._draft_forward(window, fills_d, trash, trash,
                                           tables)
            for slot in growing:
                chains[slot][0].append(int(cand[slot, depth - 1, 0]))

    def _spec_step_tree(self, plans: dict) -> None:
        """One resident-draft tree-verify iteration (pipeline flushed).
        Each planned slot spends its ``k_i``-token budget on a tree rooted
        at its pending token: the draft's repeated top-1 chain and, when
        ``k_i >= 3``, a depth-1 hedge leaf from its second choice.  The
        target scores every node in one tree verify (K14's tree mode on
        the fused route), and the longest root path whose tokens the
        target's argmax confirms commits, plus the bonus token of its
        deepest node: what plain greedy decoding would give.  Node rows
        land node-indexed at ``fill + node``; rejected ones sit past the
        new fill, and a path through the hedge is packed to depth
        positions with ``cache_move_rows`` before any commit can retire
        the slot.  Riders (sampled slots, collapsed budgets) take a
        root-only tree: an unchanged plain step."""
        it0 = time.perf_counter()
        t = self.metrics.timers("serving-decode")
        t.start()
        S = self.config.max_batch_size
        W = self.config.spec_draft_len + 1
        bk = self.slots.pool.block_size
        # the blocks of every node row (fill .. fill + k_i), and of the
        # draft's pending-token row at fill, exist before the one tables
        # snapshot both models read
        for slot, st in self._active.items():
            for j in range(plans.get(slot, 0) + 1):
                self.slots.append_block_id(slot, st.fill + j)
        tables = self._tensor(self.slots.tables.astype(np.int64))

        heads = self._draft_absorb(plans, tables)
        chains, hedges = {}, {}
        for slot, k_i in plans.items():
            top = heads[slot]
            if k_i >= 3:
                chains[slot] = ([top[0]], k_i - 1)
                hedges[slot] = top[1]
            else:
                chains[slot] = ([top[0]], k_i)
        self._draft_expand(chains, tables)

        window = np.zeros((S, W), np.int64)
        depths = np.zeros((S, W), np.int64)
        anc = np.zeros((S, W, W), np.int64)
        fills = np.zeros((S,), np.int64)
        seeds = np.zeros((S,), np.int64)
        counters = np.zeros((S,), np.int64)
        greedy = np.ones((S,), bool)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int64)
        top_ps = np.zeros((S,), np.float32)
        bids = np.zeros((S * W,), np.int64)   # default: the trash block
        offs = np.zeros((S * W,), np.int64)
        # the draft proposed under the base model; the target verifies
        # under each requester's adapter, so what commits is what plain
        # adapter decoding gives
        aslots = np.full((S,), -1, np.int64)
        n_real = {}
        for slot, st in self._active.items():
            aslots[slot] = st.adapter_slot
            window[slot, 0] = st.pending
            fills[slot] = st.fill
            seeds[slot] = st.req.seed
            counters[slot] = st.count
            greedy[slot] = st.req.greedy
            temps[slot] = st.req.temperature
            top_ks[slot] = st.req.top_k
            top_ps[slot] = st.req.top_p
            st.fresh = False
            # nodes in breadth-first order: depths non-decreasing, parents
            # before children, the deepest node last
            node_dep, parent, chain_nodes = [0], [0], [0]
            hedge = hedges.get(slot)
            chain = chains[slot][0] if slot in chains else []
            for t_, tok in enumerate(chain):
                node_dep.append(t_ + 1)
                parent.append(chain_nodes[t_])
                chain_nodes.append(len(node_dep) - 1)
                window[slot, len(node_dep) - 1] = tok
                if t_ == 0 and hedge is not None:
                    node_dep.append(1)
                    parent.append(0)
                    window[slot, len(node_dep) - 1] = hedge
            n = len(node_dep)
            n_real[slot] = n
            for j in range(1, n):
                p = parent[j]
                for dd in range(node_dep[j] - 1, -1, -1):
                    anc[slot, j, dd] = p
                    p = parent[p]
            depths[slot, :n] = node_dep
            # pad nodes: the deepest real depth and ancestors (a valid
            # tree); their rows go to the trash block, their outputs unread
            depths[slot, n:] = node_dep[-1]
            anc[slot, n:, :] = anc[slot, n - 1, :]
            for j in range(n):
                pos = st.fill + j
                bids[slot * W + j] = self.slots.tables[slot][pos // bk]
                offs[slot * W + j] = pos % bk

        t0 = time.perf_counter()
        if self._last_dispatch_t is not None:
            wall = t0 - self._last_dispatch_t
            if wall > 0 and self._last_ready_t is not None:
                gap = min(wall, t0 - self._last_ready_t)
                self.metrics.observe_step_breakdown(gap_frac=gap / wall)
        self._last_dispatch_t = t0
        self.metrics.inc_step(self._fused_verify, self._precision_route)
        with device_annotation("verify_tree", self.device):
            g_tok, g_lp = _verify_step(
                self.cfg, self.params, self.slots.pool, tables,
                self._tensor(window), self._tensor(fills),
                self._tensor(bids), self._tensor(offs), seeds, counters,
                greedy, temps, top_ks, top_ps, rope=self._rope,
                use_fused=self._fused_verify,
                tree=(self._tensor(depths), self._tensor(anc)),
                lora=self._lora(aslots))
            # synchronous by design: the accepted paths decide the next
            # fills and whether rows move
            g_tok, g_lp = g_tok.cpu().numpy(), g_lp.cpu().numpy()
        t_ready = time.perf_counter()
        self._last_ready_t = t_ready
        device_s = t_ready - t0

        # accept walk: the longest root path the target's argmax confirms
        paths = {}
        src_b = np.zeros((S * W,), np.int64)   # default trash -> trash
        src_o = np.zeros((S * W,), np.int64)
        dst_b = np.zeros((S * W,), np.int64)
        dst_o = np.zeros((S * W,), np.int64)
        any_moves = False
        for slot, st in self._active.items():
            cur, acc, path = 0, 0, [0]
            while True:
                tgt = int(g_tok[slot, cur])
                nxt = -1
                for c in range(1, n_real.get(slot, 1)):
                    if (depths[slot, c] == acc + 1
                            and anc[slot, c, acc] == cur
                            and window[slot, c] == tgt):
                        nxt = c
                        break
                if nxt < 0:
                    break
                cur = nxt
                path.append(nxt)
                acc += 1
            paths[slot] = path
            # pack the accepted path to depth positions: only a node whose
            # index differs from its depth (past the hedge leaf) moves
            for t_ in range(1, acc + 1):
                p_t = path[t_]
                if p_t == t_:
                    continue
                any_moves = True
                src, dst = st.fill + p_t, st.fill + t_
                src_b[slot * W + t_] = self.slots.tables[slot][src // bk]
                src_o[slot * W + t_] = src % bk
                dst_b[slot * W + t_] = self.slots.tables[slot][dst // bk]
                dst_o[slot * W + t_] = dst % bk
        if any_moves:
            pool = self.slots.pool
            moves = [self._tensor(a) for a in (src_b, src_o, dst_b, dst_o)]
            with device_annotation("spec_compact", self.device):
                model_lib.cache_move_rows(pool.k_pool, *moves)
                model_lib.cache_move_rows(pool.v_pool, *moves)

        total_committed = proposed = accepted_total = 0
        per_slot_committed = []
        slot_ewmas = {}
        for slot, st in list(self._active.items()):
            path = paths[slot]
            acc = len(path) - 1
            k_i = plans.get(slot, 0)
            proposed += k_i
            accepted_total += acc
            if k_i:
                chain_len = chains[slot][1]
                st.spec_ewma = ((1.0 - _SPEC_EWMA_ALPHA) * st.spec_ewma
                                + _SPEC_EWMA_ALPHA * acc / chain_len)
                slot_ewmas[slot] = st.spec_ewma
            # rows of the pending token and the accepted path landed (and
            # were packed); the bonus token's row is the next step's write
            st.fill += acc + 1
            st.count += acc + 1
            st.fresh = True
            committed_here = 0
            for t_ in range(acc + 1):
                if self._active.get(slot) is not st:
                    break  # EOS / budget retired the slot mid-path
                st.pending = int(g_tok[slot, path[t_]])
                committed_here += 1
                self._commit_token(slot, st.pending,
                                   float(g_lp[slot, path[t_]]))
            total_committed += committed_here
            if k_i:
                per_slot_committed.append(committed_here)
            if self.trace.enabled:
                self.trace.add("decode", t0, t_ready,
                               request_id=st.req.rid, tid=st.req.id,
                               args={"slot": slot, "spec": True,
                                     "tree": True, "proposed": k_i,
                                     "accepted": acc,
                                     "committed": committed_here})
        t.stop()
        self.metrics.observe_spec_step(proposed, accepted_total,
                                       per_slot_committed, source="model",
                                       slot_ewmas=slot_ewmas)
        self.metrics.observe_decode_iteration(total_committed, device_s)
        self.metrics.observe_step_breakdown(device_s=device_s)
        host_s = max(0.0, (time.perf_counter() - it0) - device_s)
        self.metrics.observe_step_breakdown(host_s=host_s)
        self.metrics.set_gauges(slots_active=self.slots.active_slots)
        self.trace.add(
            "engine_step", it0, time.perf_counter(), tid=0,
            args={"batch": len(plans),
                  "route": ("spec_fused" if self._fused_verify
                            else "spec_fallback"),
                  "pipelined": False, "tree": True, "proposed": proposed,
                  "accepted": accepted_total})

    def _commit_token(self, slot: int, token: int, logprob: float) -> None:
        """Append a sampled token, stream it, retire on EOS / budget."""
        st = self._active[slot]
        req = st.req
        req.generated.append(token)
        if req.return_logprobs:
            req.logprobs.append(logprob)
        if req.first_token_time is None:
            req.first_token_time = time.perf_counter()
            ttft = req.first_token_time - req.submit_time
            self.metrics.observe_ttft(ttft)
            EVENT_LOG.emit("engine", "first_token", request_id=req.rid,
                           ttft_s=round(ttft, 6))
        if req.on_token is not None:
            try:
                req.on_token(token)
            except Exception:  # noqa: BLE001 — a client callback must not
                logging.getLogger(__name__).exception(  # stop the scheduler
                    "on_token callback of %s failed", req.rid)
        if req.use_eos_stop and token == req.eos_id:
            self._retire(slot, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._retire(slot, "length")

    def _retire(self, slot: int, reason: str) -> None:
        st = self._active.pop(slot)
        self.trace.instant("retire", request_id=st.req.rid, tid=st.req.id,
                           args={"slot": slot, "reason": reason})
        if self.prefix_cache is not None:
            # donate the slot's block-aligned prompt prefix (a ref-count
            # adoption of blocks the slot owns) before the slot lets go,
            # then unpin the admission lease; an adapter request's rows
            # carry its adapter's deltas and never seed the cache
            if st.req.adapter_id is None:
                self.prefix_cache.offer(st.req.prompt,
                                        self.slots.tables[slot])
            self.prefix_cache.release(st.lease)
            self.metrics.set_gauges(prefix_blocks=self.prefix_cache.blocks)
        self._release_adapter(st.req)
        self.slots.release(slot)
        self._finish(st.req, reason)
        self._update_pool_gauges()
        self.metrics.set_gauges(slots_active=self.slots.active_slots)

    def _update_pool_gauges(self) -> None:
        s = self.slots.pool.stats()
        self.metrics.set_gauges(blocks_free=s["blocks_free"],
                                blocks_used=s["blocks_used"],
                                kv_cache_util=s["kv_cache_util"])
        if self.host_tier is not None:
            self.metrics.set_gauges(
                host_blocks_used=self.host_tier.host_used,
                host_blocks_free=self.host_tier.host_free)

    def kv_snapshot(self) -> dict:
        """Debug view of the paged KV state (GET /kv): pool stats, tables,
        fills, and with a host tier its occupancy and each suspended
        request's host block count (best effort under concurrent
        scheduling, like /metrics).  Under a mesh with pp > 1 a ``stages``
        section gives each stage's layer range, ranks and stage-local view
        of the ledger."""
        if self.slots is None:
            return {"pool": None, "slots": {}}
        fills = {s: st.fill for s, st in dict(self._active).items()}
        snap = self.slots.snapshot(fills)
        pp = 1 if self.mesh is None else self.mesh.size("pp")
        if pp > 1 and self.cfg.num_layers % pp == 0:
            # one ledger on rank 0 and global block ids: every stage's
            # view is the same (an imbalance would mean a stage diverged)
            from ..parallel import mesh as mesh_lib

            pool_stats = snap.get("pool") or {}
            snap["stages"] = [
                {"stage": s, "layers": [lo, hi],
                 "devices": mesh_lib.axis_ranks(self.mesh, "pp", s),
                 "blocks_free": pool_stats.get("blocks_free"),
                 "blocks_used": pool_stats.get("blocks_used"),
                 "fragmentation": snap.get("fragmentation")}
                for s, (lo, hi) in enumerate(
                    mesh_lib.stage_layer_ranges(self.cfg.num_layers, pp))]
        if self.host_tier is not None:
            snap["host_tier"] = self.host_tier.stats()
            snap["host_tier"]["suspended"] = {
                sus.req.rid: {"blocks": sus.n_live,
                              "priority": sus.req.priority,
                              "generated": len(sus.req.generated)}
                for sus in list(self._suspended.values())}
        return snap

    def _finish(self, req: _Request, reason: str) -> None:
        req.result = FinishedRequest(
            tokens=req.prompt + req.generated,
            prompt_len=len(req.prompt),
            finish_reason=reason,
            logprobs=list(req.logprobs) if req.return_logprobs else None)
        if reason == "cancelled":
            self.metrics.inc("cancelled")
        elif reason == "timeout":
            self.metrics.inc("timeouts")
        elif reason != "error":
            self.metrics.inc("completed")
            self.metrics.observe_e2e(time.perf_counter() - req.submit_time)
        # availability: timeouts and scheduler errors are the server's
        # fault; eos / length / cancelled finishes are service
        self.metrics.observe_finish(reason not in ("timeout", "error"))
        EVENT_LOG.emit("engine", "finished", request_id=req.rid,
                       reason=reason, generated=len(req.generated),
                       e2e_s=round(time.perf_counter() - req.submit_time, 6))
        req.done_event.set()
        self._notify_drain()

    # -- tiered KV: decode preemption to the host tier -----------------------

    def _preempt_slot(self, slot: int) -> bool:
        """Suspend an active decode to the host tier.  The demote (its
        gather first) runs before any state changes, so a
        ``host-swap-out`` fault returns False with the slot decoding on;
        on success the slot's blocks free at once and its scheduling
        state moves into ``_suspended`` for a bitwise resume."""
        self._flush_inflight()  # may retire the victim (EOS / budget)
        st = self._active.get(slot)
        if st is None:
            return False
        req = st.req
        bids = self.slots.live_bids(slot)
        if not bids or not self.host_tier.can_store(len(bids)):
            return False
        t0 = time.perf_counter()
        try:
            hids = self.host_tier.begin_demote(bids, owner=req.rid)
        except OSError as e:  # before any state changed: decode on here
            EVENT_LOG.emit("engine", "swap_out_failed", request_id=req.rid,
                           slot=slot, error=repr(e))
            return False
        self._active.pop(slot)
        if self.prefix_cache is not None:
            # unpin without offering: suspended, not retiring
            self.prefix_cache.release(st.lease)
        self._release_adapter(req)
        self.slots.release(slot)
        self._suspended[req.id] = _Suspended(
            req, hids, len(bids),
            meta={"fill": st.fill, "count": st.count,
                  "pending": st.pending, "spec_ewma": st.spec_ewma,
                  "spec_stall": st.spec_stall},
            t_suspend=t0)
        nbytes = self.host_tier.block_nbytes * len(bids)
        self.metrics.inc("preemptions_total")
        self._update_pool_gauges()
        self.metrics.set_gauges(slots_active=self.slots.active_slots)
        EVENT_LOG.emit("engine", "swapped", request_id=req.rid,
                       direction="out", blocks=len(bids), bytes=nbytes)
        EVENT_LOG.emit("engine", "preempted", request_id=req.rid,
                       slot=slot, priority=req.priority,
                       blocks=len(bids), generated=len(req.generated))
        self.trace.add("preempt", t0, time.perf_counter(),
                       request_id=req.rid, tid=req.id,
                       args={"slot": slot, "blocks": len(bids),
                             "priority": req.priority})
        return True

    def _maybe_resume(self) -> None:
        """Bring suspended decodes back when a slot and a full reservation
        are free: highest priority first, oldest suspension within a
        class, never ahead of a strictly higher-priority parked
        admission."""
        if not self._suspended:
            return
        pool = self.slots.pool
        bk = pool.block_size
        for sus in sorted(self._suspended.values(),
                          key=lambda s: (-s.req.priority, s.t_suspend)):
            req = sus.req
            if not self.slots.free_slots:
                break
            if (self._held is not None
                    and self._held.priority > req.priority):
                break
            total = -(-(len(req.prompt) + req.max_new_tokens) // bk)
            need = max(total, sus.n_live)
            if not pool.can_reserve(need) and self.prefix_cache is not None:
                # cached prefixes must not starve a suspended decode (JAX
                # squeezes the cache for admissions only, so once nothing
                # new arrives a decode suspended behind it never resumes)
                self.prefix_cache.evict_blocks(
                    need - (pool.free_blocks - pool.reserved_blocks))
                self.metrics.set_gauges(
                    prefix_blocks=self.prefix_cache.blocks)
            if not pool.can_reserve(need):
                continue  # a smaller suspended request may still fit
            try:
                self._resume_suspended(sus)
            except OSError:
                # a host-swap-in fault or adapter pressure: the host copy
                # stays, re-fetched at a later iteration
                break

    def _discard_suspended(self, key: int, reason: str) -> None:
        sus = self._suspended.pop(key)
        self.host_tier.free(sus.hids)
        self._finish(sus.req, reason)
        self._update_pool_gauges()

    def _resume_suspended(self, sus: _Suspended) -> int:
        """Swap a suspended decode back in and rebuild its slot state; its
        rows come back bitwise and its sampling folds on its own ``(seed,
        count)``.  Raises ``OSError`` (the host copy intact, the ledger
        balanced) when the swap-in faults or the adapter arena is
        pinned shut."""
        req = sus.req
        pool = self.slots.pool
        t0 = time.perf_counter()
        slot = self.slots.alloc()
        aslot = self._acquire_adapter(req)
        if aslot is None:
            self.slots.release(slot)
            raise OSError("adapter arena fully pinned; resume deferred")
        bk = pool.block_size
        total = -(-(len(req.prompt) + req.max_new_tokens) // bk)
        need = max(total, sus.n_live)
        if not pool.reserve(need):
            self._release_adapter(req)
            self.slots.release(slot)
            raise OSError("pool cannot reserve for resume")
        self.slots.set_reservation(slot, need)
        table = np.full(self.slots.table_blocks, BlockPool.TRASH, np.int32)
        for i in range(sus.n_live):
            table[i] = pool.alloc_reserved()
            self.slots.reserved[slot] -= 1
        self.slots.tables[slot] = table
        try:
            self.host_tier.promote(sus.hids, table[:sus.n_live])
        except OSError:
            # unwind: release drops the fresh blocks and the reservation;
            # the host copy stays for a later re-fetch
            self.slots.release(slot)
            self._release_adapter(req)
            self._update_pool_gauges()
            raise
        self.host_tier.free(sus.hids)
        del self._suspended[req.id]
        st = _SlotState(req, fill=sus.meta["fill"],
                        pending=sus.meta["pending"])
        st.count = sus.meta["count"]
        st.spec_ewma = sus.meta["spec_ewma"]
        st.spec_stall = sus.meta["spec_stall"]
        st.adapter_slot = aslot
        st.fresh = True  # the next dispatch feeds the host-known token
        self._active[slot] = st
        if self._draft_enabled:
            # the draft's shadow rows are derived state: rebuilt
            self._draft_prefill(slot, st)
        dt = time.perf_counter() - t0
        suspended_s = t0 - sus.t_suspend
        nbytes = self.host_tier.block_nbytes * sus.n_live
        self.metrics.inc("resumes_total")
        self.metrics.observe_resume(dt)
        self._update_pool_gauges()
        self.metrics.set_gauges(slots_active=self.slots.active_slots)
        EVENT_LOG.emit("engine", "swapped", request_id=req.rid,
                       direction="in", blocks=sus.n_live, bytes=nbytes)
        EVENT_LOG.emit("engine", "resumed", request_id=req.rid, slot=slot,
                       priority=req.priority,
                       suspended_s=round(suspended_s, 6),
                       resume_s=round(dt, 6))
        self.trace.add("resume", t0, time.perf_counter(),
                       request_id=req.rid, tid=req.id,
                       args={"slot": slot, "blocks": sus.n_live,
                             "suspended_s": round(suspended_s, 6)})
        return slot


def _same_tree(a, b) -> bool:
    """Whether two parameter trees (nested dicts of tensors) have the same
    keys, shapes and dtypes."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    return (isinstance(b, torch.Tensor) and a.shape == b.shape
            and a.dtype == b.dtype and a.device == b.device)
