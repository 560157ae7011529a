"""Serving counters, gauges and latency reservoirs (mirror of
``megatron_llm_tpu/serving/metrics.py``).  Host-side and lock-guarded: the
scheduler thread and HTTP threads write, tests and pollers read.

Every ``ServingMetrics`` registers itself as the ``"serving"`` collector
of ``obs.REGISTRY`` (newest instance wins; ``register=False`` opts out),
so ``GET /metrics?format=prometheus`` scrapes its counters, gauges and
reservoir summaries under ``serving_*`` names beside the resilience
counters; ``snapshot()`` backs the JSON ``GET /metrics``.  An
``obs.SLOTracker`` rides along (``self.slo``), fed from the TTFT,
decode-iteration and finish observers.  The counters of the serving
cluster (shipping) come with it.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from ..analysis.sanitizers import make_lock
from ..obs.registry import REGISTRY, MetricFamily, summary_family
from ..obs.slo import SLOConfig, SLOTracker


class LatencyHistogram:
    """Bounded reservoir of recent samples with mean / percentile readout;
    ``total_count`` / ``total`` are all-time aggregates."""

    def __init__(self, max_samples: int = 4096):
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._count = 0
        self._total = 0.0

    def observe(self, seconds: float) -> None:
        self._count += 1
        self._total += seconds
        self._samples.append(seconds)
        if len(self._samples) > self.max_samples:
            del self._samples[:len(self._samples) - self.max_samples]

    @property
    def total_count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._total

    def mean(self) -> float:
        return sum(self._samples) / len(self._samples) if self._samples \
            else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100], nearest-rank over the retained window."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        idx = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def snapshot(self, suffix: str = "_s") -> dict:
        out = {"count": len(self._samples), "total_count": self._count,
               f"mean{suffix}": self.mean()}
        for p in (50, 95, 99):
            out[f"p{p}{suffix}"] = self.percentile(p)
        return out

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict:
        """{q: value} for the Prometheus summary export."""
        return {q: self.percentile(100.0 * q) for q in qs}


class Timer:
    """Accumulating wall-clock timer (``start``/``stop`` pairs)."""

    def __init__(self):
        self.elapsed_s = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.elapsed_s += time.perf_counter() - self._t0
            self.count += 1
            self._t0 = None


_COUNTERS = (
    "submitted", "admitted", "completed", "cancelled", "timeouts",
    "rejected_queue_full", "rejected_invalid", "rejected_draining",
    "prefills", "prefill_chunks", "decode_iterations", "decode_tokens",
    "fused_steps", "fallback_steps",
    # speculative decoding: draft tokens the drafter (host n-gram or the
    # resident draft model) proposed, those the verify steps accepted, and
    # verify steps run
    "spec_proposed", "spec_accepted", "spec_steps",
    # automatic prefix caching (serving/prefix_cache.py): admissions that
    # reused cached prefix K/V or prefilled cold, blocks LRU-evicted, and
    # copy-on-write block copies (nonzero on a pure prefix-hit load means
    # zero-copy sharing broke)
    "prefix_hits", "prefix_misses", "prefix_evicted_blocks",
    "cow_copies_total",
    # multi-tenant LoRA (serving/adapters/): admissions whose adapter was
    # already arena-resident vs installed cold, unpinned adapters evicted
    # under the adapter_cache_slots budget, and arena installs
    "adapter_hits", "adapter_misses", "adapter_evictions",
    "adapter_installs",
    # live base-weight swaps (engine.swap_params)
    "param_swaps",
    # tiered KV (block_pool.py:HostKVTier): blocks moved between the pool
    # and the host tier, the bytes of both directions, decodes suspended
    # to the host (preemptions) and resumed, and spilled prefix-cache
    # blocks promoted back on a hit
    "swap_out_blocks_total", "swap_in_blocks_total", "swap_bytes_total",
    "preemptions_total", "resumes_total", "prefix_promotions_total",
)

# (attribute, Prometheus family name, help) of the latency reservoirs
_PROM_SUMMARIES = (
    ("ttft", "serving_ttft_seconds", "time to first token"),
    ("per_token", "serving_per_token_latency_seconds",
     "per-token decode latency (one sample per token per iteration)"),
    ("e2e", "serving_e2e_latency_seconds", "request end-to-end latency"),
    ("device_step", "serving_device_step_seconds",
     "decode dispatch to tokens-on-host"),
    ("sched_host", "serving_sched_host_seconds",
     "scheduler host bookkeeping per iteration"),
    ("prefix_hit_tokens", "serving_prefix_hit_tokens",
     "tokens per admission served from the prefix cache"),
    ("accepted_per_step", "serving_accepted_tokens_per_step",
     "tokens committed per participating slot per speculative verify step"),
    ("resume_latency", "serving_resume_latency_seconds",
     "preempted-decode resume latency (host swap-in to decodable)"),
)


class ServingMetrics:
    """Thread-safe serving counter / gauge / histogram set; unless
    ``register=False`` the instance becomes ``obs.REGISTRY``'s
    ``"serving"`` collector (replacing any earlier one)."""

    def __init__(self, num_slots: int = 0,
                 slo: Optional[SLOConfig] = None, register: bool = True):
        self._lock = make_lock("serving.metrics")
        self.counters = {name: 0 for name in _COUNTERS}
        self.num_slots = num_slots
        self.slots_active = 0
        self.queue_depth = 0
        self.max_decode_batch = 0
        self.blocks_free = 0
        self.blocks_used = 0
        self.kv_cache_util = 0.0
        # the host tier's occupancy and the preempted decodes' resume
        # latency (tiered KV)
        self.host_blocks_used = 0
        self.host_blocks_free = 0
        self.resume_latency = LatencyHistogram()
        # tokens a prefix-cache hit skipped (samples are token counts) and
        # the blocks the cache holds
        self.prefix_hit_tokens = LatencyHistogram()
        self.prefix_blocks = 0
        # the LoRA arena's resident adapters and their factor bytes
        self.adapter_resident = 0
        self.adapter_resident_bytes = 0
        self.ttft = LatencyHistogram()
        self.per_token = LatencyHistogram()
        self.e2e = LatencyHistogram()
        # dispatch -> tokens on host, and Python bookkeeping, per iteration;
        # device_idle_frac = EWMA of the share of inter-dispatch wall time
        # the device waited on the host
        self.device_step = LatencyHistogram()
        self.sched_host = LatencyHistogram()
        self.device_idle_frac: Optional[float] = None
        # fused / fallback decode iterations by the weight precision route
        # (ops/quant.py:precision_route: fp32 / int8 / int4 / mixed)
        self.step_routes: dict = {}
        # tokens committed per participating slot per verify step (samples
        # are token counts), the speculative counters by draft source, and
        # each slot's acceptance EWMA (what the draft budget steers on)
        self.accepted_per_step = LatencyHistogram()
        self.spec_by_source: dict = {}
        self.slot_spec_ewma: dict = {}
        self._timers: dict = {}
        self.slo = SLOTracker(slo or SLOConfig())
        if register:
            REGISTRY.register_collector("serving", self.collect)

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] += by

    def inc_step(self, fused: bool, route: str = "fp32") -> None:
        """One decode iteration: the aggregate fused / fallback counter and
        its per-precision-route breakdown (JAX ``metrics.py:264-272``)."""
        with self._lock:
            self.counters["fused_steps" if fused else "fallback_steps"] += 1
            r = self.step_routes.setdefault(route,
                                            {"fused": 0, "fallback": 0})
            r["fused" if fused else "fallback"] += 1

    def timers(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def set_gauges(self, *, slots_active: Optional[int] = None,
                   queue_depth: Optional[int] = None,
                   blocks_free: Optional[int] = None,
                   blocks_used: Optional[int] = None,
                   kv_cache_util: Optional[float] = None,
                   num_slots: Optional[int] = None,
                   prefix_blocks: Optional[int] = None,
                   adapter_resident: Optional[int] = None,
                   adapter_resident_bytes: Optional[int] = None,
                   host_blocks_used: Optional[int] = None,
                   host_blocks_free: Optional[int] = None) -> None:
        with self._lock:
            for name, value in (("slots_active", slots_active),
                                ("queue_depth", queue_depth),
                                ("blocks_free", blocks_free),
                                ("blocks_used", blocks_used),
                                ("kv_cache_util", kv_cache_util),
                                ("num_slots", num_slots),
                                ("prefix_blocks", prefix_blocks),
                                ("adapter_resident", adapter_resident),
                                ("adapter_resident_bytes",
                                 adapter_resident_bytes),
                                ("host_blocks_used", host_blocks_used),
                                ("host_blocks_free", host_blocks_free)):
                if value is not None:
                    setattr(self, name, value)

    def observe_decode_iteration(self, batch: int, seconds: float) -> None:
        with self._lock:
            self.counters["decode_iterations"] += 1
            self.counters["decode_tokens"] += batch
            self.max_decode_batch = max(self.max_decode_batch, batch)
            for _ in range(batch):
                self.per_token.observe(seconds)
        self.slo.record_itl(seconds, n=batch)

    def observe_step_breakdown(self, *, device_s: Optional[float] = None,
                               host_s: Optional[float] = None,
                               gap_frac: Optional[float] = None) -> None:
        with self._lock:
            if device_s is not None:
                self.device_step.observe(device_s)
            if host_s is not None:
                self.sched_host.observe(host_s)
            if gap_frac is not None:
                gap_frac = min(1.0, max(0.0, gap_frac))
                self.device_idle_frac = (
                    gap_frac if self.device_idle_frac is None
                    else 0.9 * self.device_idle_frac + 0.1 * gap_frac)

    def observe_spec_step(self, proposed: int, accepted: int, committed,
                          source: str = "ngram",
                          slot_ewmas: Optional[dict] = None) -> None:
        """One verify step: ``proposed`` draft tokens over the batch,
        ``accepted`` of them confirmed, ``committed`` tokens landed per
        participating slot (accepted prefix + the next token, cut by
        EOS/budget); ``source`` names the drafter."""
        with self._lock:
            self.counters["spec_steps"] += 1
            self.counters["spec_proposed"] += proposed
            self.counters["spec_accepted"] += accepted
            src = self.spec_by_source.setdefault(
                source, {"steps": 0, "proposed": 0, "accepted": 0})
            src["steps"] += 1
            src["proposed"] += proposed
            src["accepted"] += accepted
            if slot_ewmas:
                self.slot_spec_ewma.update(slot_ewmas)
            for n in committed:
                self.accepted_per_step.observe(float(n))

    def observe_prefix_hit_tokens(self, tokens: int) -> None:
        """Tokens whose prefill one prefix-cache hit skipped."""
        with self._lock:
            self.prefix_hit_tokens.observe(float(tokens))

    def observe_ttft(self, seconds: float) -> None:
        with self._lock:
            self.ttft.observe(seconds)
        self.slo.record_ttft(seconds)

    def observe_e2e(self, seconds: float) -> None:
        with self._lock:
            self.e2e.observe(seconds)

    def observe_resume(self, seconds: float) -> None:
        """A preempted decode's resume: host swap-in start to decodable."""
        with self._lock:
            self.resume_latency.observe(seconds)

    def observe_finish(self, ok: bool) -> None:
        """A request retired; ``ok`` False on timeout / error (the
        availability objective)."""
        self.slo.record_request(ok)

    def snapshot(self) -> dict:
        """Point-in-time dict of every counter, gauge and histogram."""
        with self._lock:
            out = dict(self.counters)
            out.update({
                "running": self.slots_active,
                "queued": self.queue_depth,
                "slots_total": self.num_slots,
                "slot_occupancy": (self.slots_active / self.num_slots
                                   if self.num_slots else 0.0),
                "max_decode_batch": self.max_decode_batch,
                "ttft": self.ttft.snapshot(),
                "per_token_latency": self.per_token.snapshot(),
                "e2e_latency": self.e2e.snapshot(),
                "device_step_time": self.device_step.snapshot(),
                "sched_host_time": self.sched_host.snapshot(),
                "device_idle_frac": self.device_idle_frac or 0.0,
                "blocks_free": self.blocks_free,
                "blocks_used": self.blocks_used,
                "kv_cache_util": self.kv_cache_util,
                # the host tier of tiered KV
                "host_blocks_used": self.host_blocks_used,
                "host_blocks_free": self.host_blocks_free,
                "resume_latency": self.resume_latency.snapshot(),
                # prefix cache (the histogram samples are token counts)
                "prefix_hit_rate": (
                    self.counters["prefix_hits"]
                    / max(1, self.counters["prefix_hits"]
                          + self.counters["prefix_misses"])),
                "prefix_blocks": self.prefix_blocks,
                "prefix_hit_tokens": self.prefix_hit_tokens.snapshot(
                    suffix=""),
                # multi-tenant LoRA arena residency
                "adapter_hit_rate": (
                    self.counters["adapter_hits"]
                    / max(1, self.counters["adapter_hits"]
                          + self.counters["adapter_misses"])),
                "adapter_resident": self.adapter_resident,
                "adapter_resident_bytes": self.adapter_resident_bytes,
                # decode-step routing by weight precision (inc_step)
                "step_routes": {route: dict(r) for route, r
                                in sorted(self.step_routes.items())},
                "spec_acceptance_rate": (
                    self.counters["spec_accepted"]
                    / max(1, self.counters["spec_proposed"])),
                "spec_by_source": {
                    source: dict(src)
                    for source, src in sorted(self.spec_by_source.items())},
                "slot_spec_ewma": {
                    str(slot): ewma
                    for slot, ewma in sorted(self.slot_spec_ewma.items())},
                "accepted_tokens_per_step":
                    self.accepted_per_step.snapshot(suffix=""),
                "timers_s": {name: t.elapsed_s
                             for name, t in sorted(self._timers.items())},
            })
        out["slo"] = self.slo.snapshot()
        return out

    def collect(self) -> List[MetricFamily]:
        """``obs.REGISTRY`` collector: every counter, gauge and reservoir
        summary under ``serving_*`` names, and the SLO gauges (JAX
        ``ServingMetrics.collect``, family for family)."""
        fams: List[MetricFamily] = []
        with self._lock:
            for name in _COUNTERS:
                # a counter already named ``*_total`` keeps one suffix
                pname = (f"serving_{name}" if name.endswith("_total")
                         else f"serving_{name}_total")
                fams.append(MetricFamily(
                    pname, "counter",
                    f"serving lifecycle counter: {name}").add(
                        self.counters[name]))
            if self.step_routes:
                fused_fam = MetricFamily(
                    "serving_fused_steps_by_precision_total", "counter",
                    "fused decode iterations by weight precision route")
                fb_fam = MetricFamily(
                    "serving_fallback_steps_by_precision_total", "counter",
                    "composed-path decode iterations by weight precision "
                    "route")
                for route, r in sorted(self.step_routes.items()):
                    fused_fam.add(r["fused"], labels={"precision": route})
                    fb_fam.add(r["fallback"], labels={"precision": route})
                fams.extend([fused_fam, fb_fam])
            if self.spec_by_source:
                by_src = {
                    "steps": MetricFamily(
                        "serving_spec_steps_by_source_total", "counter",
                        "speculative verify steps by draft source"),
                    "proposed": MetricFamily(
                        "serving_spec_proposed_by_source_total", "counter",
                        "speculative draft tokens proposed by draft source"),
                    "accepted": MetricFamily(
                        "serving_spec_accepted_by_source_total", "counter",
                        "speculative draft tokens accepted by draft source"),
                }
                for source, src in sorted(self.spec_by_source.items()):
                    for key, fam in by_src.items():
                        fam.add(src[key],
                                labels={"spec_draft_source": source})
                fams.extend(by_src.values())
            if self.slot_spec_ewma:
                ewma_fam = MetricFamily(
                    "serving_spec_slot_ewma", "gauge",
                    "per-slot speculative acceptance EWMA (budget "
                    "controller input)")
                for slot, ewma in sorted(self.slot_spec_ewma.items()):
                    ewma_fam.add(ewma, labels={"slot": str(slot)})
                fams.append(ewma_fam)
            hits = self.counters["prefix_hits"]
            misses = self.counters["prefix_misses"]
            for gname, help_, value in (
                    ("serving_slots_active", "slots currently decoding",
                     self.slots_active),
                    ("serving_slots_total", "configured KV slots",
                     self.num_slots),
                    ("serving_queue_depth", "requests waiting for a slot",
                     self.queue_depth),
                    ("serving_max_decode_batch",
                     "largest decode batch observed", self.max_decode_batch),
                    ("serving_device_idle_frac",
                     "EWMA fraction of step wall time the device sat idle",
                     self.device_idle_frac or 0.0),
                    ("serving_prefix_blocks",
                     "K/V blocks resident in the prefix cache",
                     self.prefix_blocks),
                    ("serving_prefix_hit_rate",
                     "prefix-cache admission hit rate",
                     hits / max(1, hits + misses)),
                    ("serving_adapter_resident",
                     "LoRA adapters resident in the arena",
                     self.adapter_resident),
                    ("serving_adapter_resident_bytes",
                     "fp32 factor bytes resident in the LoRA arena",
                     self.adapter_resident_bytes),
                    ("serving_adapter_hit_rate",
                     "adapter-cache admission hit rate",
                     self.counters["adapter_hits"]
                     / max(1, self.counters["adapter_hits"]
                           + self.counters["adapter_misses"])),
                    ("serving_blocks_free",
                     "KV pool blocks on the free list", self.blocks_free),
                    ("serving_blocks_used",
                     "KV pool blocks allocated to slots or the prefix cache",
                     self.blocks_used),
                    ("serving_kv_cache_util",
                     "allocated-token fraction of the KV pool",
                     self.kv_cache_util),
                    ("serving_host_blocks_used",
                     "host-RAM tier KV blocks in use", self.host_blocks_used),
                    ("serving_host_blocks_free",
                     "host-RAM tier KV blocks free", self.host_blocks_free),
                    ("serving_spec_acceptance_rate",
                     "speculative draft tokens accepted / proposed",
                     self.counters["spec_accepted"]
                     / max(1, self.counters["spec_proposed"]))):
                fams.append(MetricFamily(gname, "gauge", help_).add(value))
            for attr, pname, help_ in _PROM_SUMMARIES:
                hist: LatencyHistogram = getattr(self, attr)
                fams.append(summary_family(
                    pname, help_, count=hist.total_count, total=hist.total,
                    quantiles=hist.quantiles()))
        fams.extend(self.slo.collect(prefix="serving_slo"))
        return fams
