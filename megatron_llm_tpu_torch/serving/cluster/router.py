"""Replicated-engine router: health-aware dispatch and drain / kill
failover (mirror of ``megatron_llm_tpu/serving/cluster/router.py``).

The router owns N ``ServingEngine`` replicas and presents the engine's
own submission surface (``submit_many`` → handles with
``result()/cancel()/rid``), so ``generation/server.py`` serves through a
Router exactly as it serves through one engine.

Dispatch is least-loaded over each replica's ``ServingMetrics`` /
``SLOTracker``: replicas whose SLO burn says unhealthy are deprioritized
(not excluded: a degraded replica beats a dropped request), draining and
dead replicas are excluded, and ties break on adapter affinity, then on
(queue depth + active slots, -free blocks).  A request streams from the
one replica it was dispatched to, and an optional ``sticky_key`` spec
field pins related requests (one conversation hitting the same replica's
prefix cache) together while that replica stays usable.

Failover reuses the engine's own machinery:

* ``drain_replica`` pulls not-yet-started requests out of the replica's
  queue (``RequestQueue.remove``, atomic: the scheduler owns a request or
  the router does, never both), resubmits them elsewhere, then runs
  ``engine.drain`` so in-flight streams finish in place.
* A replica whose scheduler died (its request finished with ``error``, or
  the probe sees the thread gone) or that was killed gets every
  unfinished request resubmitted with its resolved seed.  A sampled token
  depends on the request's ``(seed, count)`` stream and its logits only,
  never on its slot or batch, so the replay is the same trajectory;
  tokens the client already has are suppressed by count (``_stream``),
  and the client's stream is bitwise the uninterrupted one.

**Sharded replicas in a port of one process a rank.**  JAX's router owns
every replica's engine in one process, each replica on its own device
slice.  The port runs one process a rank, and a sharded engine
(``sharded.build_sharded_engine``) is split between the rank that runs
it and drives it (``MeshDriver``) and the ranks that replay it
(``MeshWorker.serve``).  The design chosen: **the router's process leads
every replica.**  Global rank 0 runs the ``Router`` and every replica's
``ServingEngine`` and ``MeshDriver`` (the queue, the scheduler thread,
the ledger, the sampling); replica r's other ranks are worker processes.
A world of ``1 + R * (n - 1)`` processes serves R replicas of n ranks,
rank 0 holding each replica's first shard on that replica's first device
(``parallel/mesh.replica_submeshes``).  This keeps JAX's shape: the
router holds real engine objects, so ``RequestQueue.remove``,
``call_in_scheduler`` and the probes work on them as JAX's do, the sharded
driver / worker seam serves unchanged, and handles, streams and queue
removal need no remote call.  (The alternative, a lead process a replica
reached through a proxy of the engine surface, would put a remote
procedure call under every one of those.)  Each replica's meshes and
control channel are groups of their own over its ranks, and each
scheduler thread makes its own replica's mesh current (``use_mesh``
keeps a stack a thread).  A worker's fault leaves its replica's groups
only (``sharded._leave``): it surfaces on rank 0 as that replica's
scheduler error, the probe marks the replica dead and ``_failover``
resubmits its requests while the other replicas serve on.  ``kill_replica``
shuts the replica's engine, which sends its workers ``stop``.

Every router lock comes from ``analysis.sanitizers.make_lock``, so the
lock-order detector covers the router ↔ engine interleavings, and every
hop is correlated by the engine's ``request_id`` in EVENT_LOG lines
(``routed`` / ``replica_draining`` / ``replica_drained`` /
``replica_dead`` / ``resubmitted``) and the router's trace spans
(``route`` / ``failover`` / ``drain``).

Not in this slice, each raising ``NotImplementedError`` naming its item of
ROADMAP.md Queue 1: KV shipments between replicas (prefill → decode
handoff, ``migrate_request``, ``rolling_swap``) and the cluster half of
multi-tenant LoRA (``register_adapter``), item 11 (c); the supervisor that
rebuilds dead replicas, item 11 (d).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

from ...analysis import sanitizers
from ...obs import REGISTRY
from ...obs.logging import EVENT_LOG
from ...obs.registry import MetricFamily
from ...obs.trace import TraceRecorder
from ..engine import FinishedRequest, RequestHandle, ServingEngine
from ..queue import QueueFull


def _item_c(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item 11 (c): "
        "shipments between replicas, disaggregation, live migration and "
        "the cluster's adapters)")


@dataclasses.dataclass
class RouterConfig:
    probe_interval_s: float = 0.05   # health probe + completion sweep
    max_resubmits: int = 2           # per-request failover budget
    slo_max_burn: float = 2.0        # healthy() threshold for dispatch
    sticky: bool = True              # honor spec["sticky_key"]
    drain_timeout_s: float = 30.0    # per-replica engine.drain bound
    trace: bool = True
    trace_capacity: int = 4096
    # poison-request quarantine: a request in flight at this many replica
    # crashes is finished with reason "quarantined" instead of being
    # resubmitted to kill another replica; 0 never quarantines
    quarantine_after: int = 2


class Replica:
    """One engine and the router's view of its health."""

    def __init__(self, rid: str, engine: ServingEngine):
        self.id = rid
        self.engine = engine
        self.draining = False
        self.dead = False
        self.dispatched = 0
        self.completed = 0
        # incarnation counter (the supervisor's, item 11 (d), bumps it)
        self.generation = 0

    @property
    def role(self) -> str:
        """The engine's role: "prefill" | "decode" | "mixed"."""
        return self.engine.config.role

    def alive(self) -> bool:
        e = self.engine
        if self.dead or e._scheduler_error is not None:
            return False
        t = e._thread
        return not (e._started.is_set() and (t is None or not t.is_alive()))

    def load(self) -> tuple:
        """(queue_depth + active, -blocks_free): lower is less loaded."""
        e = self.engine
        active = e.slots.active_slots if e.slots is not None else 0
        free = (e.slots.pool.free_blocks if e.slots is not None
                else 1 << 30)
        return (len(e.queue) + active, -free)

    def healthy(self, max_burn: float) -> bool:
        return self.alive() and self.engine.metrics.slo.healthy(max_burn)

    def probe(self, max_burn: float) -> dict:
        e = self.engine
        s = (e.slots.pool.stats() if e.slots is not None
             else {"blocks_free": None, "blocks_used": None})
        return {
            "id": self.id,
            "role": self.role,
            "alive": self.alive(),
            "healthy": self.healthy(max_burn),
            "draining": self.draining,
            "generation": self.generation,
            "heartbeat_age_s": time.perf_counter() - e.heartbeat,
            "queue_depth": len(e.queue),
            "slots_active": (e.slots.active_slots
                             if e.slots is not None else 0),
            "blocks_free": s["blocks_free"],
            "dispatched": self.dispatched,
            "completed": self.completed,
            "slo": e.metrics.slo.snapshot(),
        }


def _no_affinity(r: Replica, adapter_id: Optional[str]) -> bool:
    """Sort-key term for adapter affinity: False (sorts first) when the
    replica's arena already holds the adapter; base requests see every
    replica as equal."""
    if adapter_id is None:
        return False
    a = r.engine.adapters
    return not (a is not None and a.is_resident(adapter_id))


class _Routed:
    """The router's record of a request: it survives failover."""

    __slots__ = ("spec", "user_on_token", "sticky_key", "handle",
                 "replica", "delivered", "skip", "resubmits", "final",
                 "done_event", "failed", "attempt", "crashes", "deadline")

    def __init__(self, spec: dict, user_on_token, sticky_key,
                 handle: Optional[RequestHandle], replica: Replica):
        self.spec = spec                  # seed resolved; no on_token
        self.user_on_token = user_on_token
        self.sticky_key = sticky_key
        self.handle = handle              # the current engine handle
        self.replica = replica
        self.delivered = 0                # tokens the client has seen
        self.skip = 0                     # replayed tokens to suppress
        self.resubmits = 0
        self.attempt = 0                  # fences stale attempts' streams
        self.crashes = 0                  # replica crashes seen in flight
        # the ORIGINAL absolute deadline (perf_counter): a resubmit gets
        # the remaining budget, not a fresh one
        self.deadline: Optional[float] = None
        self.final: Optional[FinishedRequest] = None
        self.failed: Optional[str] = None
        self.done_event = threading.Event()


class RouterHandle:
    """The client's view of a routed request: ``RequestHandle``'s surface,
    failover included."""

    def __init__(self, router: "Router", rr: _Routed):
        self._router = router
        self._rr = rr

    @property
    def rid(self) -> str:
        """The engine id of the CURRENT attempt (it changes on failover;
        each EVENT_LOG ``resubmitted`` line links the old to the new)."""
        return self._rr.handle.rid

    @property
    def request_id(self) -> int:
        return self._rr.handle.request_id

    def done(self) -> bool:
        return self._rr.done_event.is_set()

    def cancel(self) -> None:
        self._rr.handle.cancel()

    def result(self, timeout: Optional[float] = None) -> FinishedRequest:
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        rr = self._rr
        while True:
            if rr.done_event.is_set():
                if rr.final is not None:
                    return rr.final
                raise RuntimeError(
                    f"request failed after {rr.resubmits} resubmits: "
                    f"{rr.failed}")
            h = rr.handle
            remaining = (None if deadline is None
                         else deadline - time.perf_counter())
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"routed request {h.rid} not finished within "
                    f"{timeout}s")
            wait = 0.1 if remaining is None else min(0.1, remaining)
            # the current attempt's completion; the short wait re-reads
            # rr.handle after a failover swapped it
            if h._req.done_event.wait(wait):
                self._router._settle(rr)


class Router:
    """Least-loaded, health-aware front end over engine replicas."""

    def __init__(self, engines: Sequence[ServingEngine],
                 config: Optional[RouterConfig] = None):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        self.config = config or RouterConfig()
        self.replicas: List[Replica] = [
            Replica(f"replica-{i}", e) for i, e in enumerate(engines)]
        self.trace = TraceRecorder(capacity=self.config.trace_capacity,
                                   enabled=self.config.trace)
        self._lock = sanitizers.make_lock("router.state")
        self._pending: dict[int, _Routed] = {}  # id(rr) -> rr
        self._sticky: dict[str, str] = {}       # sticky_key -> replica id
        self._draining = False
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self.routed_total = 0
        self.resubmitted_total = 0
        self.failovers_total = 0
        self.completed_total = 0
        # item 11 (c)'s counters, kept at 0 so the snapshot has JAX's keys
        self.ships_total = 0
        self.migrations_total = 0
        self.ship_bytes_total = 0
        self.rolling_swaps_total = 0
        self.quarantined_total = 0
        self._shipments: dict[str, dict] = {}
        # the self-healing supervisor (item 11 (d)) would attach here
        self.supervisor = None
        self.metrics = _RouterMetrics(self)
        REGISTRY.register_collector("cluster", self.metrics.collect)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Router":
        with self._lock:
            if self._probe_thread is None:
                for r in self.replicas:
                    r.engine.start()
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, name="cluster-router",
                    daemon=True)
                self._probe_thread.start()
        return self

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._lock:
            t, self._probe_thread = self._probe_thread, None
        if t is not None:
            t.join(timeout)
        for r in self.replicas:
            r.engine.shutdown(timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Server-wide graceful drain: stop accepting, drain every replica
        in place (no resubmission: there is nowhere to go)."""
        self._draining = True
        ok = True
        for r in self.replicas:
            r.draining = True
            ok = r.engine.drain(timeout) and ok
        return ok

    # -- submission (any thread) ------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw) -> RouterHandle:
        return self.submit_many([dict(prompt=prompt,
                                      max_new_tokens=max_new_tokens,
                                      **kw)])[0]

    def submit_many(self, specs: Sequence[dict]) -> List[RouterHandle]:
        """Route each spec to the least-loaded usable replica.

        The engine's contract (``ValueError`` for a request that never
        fits, ``QueueFull`` under backpressure); on a failure mid-batch the
        routed prefix is cancelled, so the batch is all-or-nothing to the
        caller."""
        self.start()
        if self._draining:
            EVENT_LOG.emit("router", "router_queue_full",
                           reason="draining", pending=len(self._pending))
            raise QueueFull("router is draining; not accepting requests",
                            retry_after_s=self._retry_after_s())
        handles: List[RouterHandle] = []
        try:
            for spec in specs:
                handles.append(self._route_one(dict(spec)))
        except Exception:
            for h in handles:
                h.cancel()
            raise
        return handles

    def _route_one(self, spec: dict) -> RouterHandle:
        # resolve the seed NOW: a resubmitted request must replay the same
        # per-request stream to be bitwise the same
        if spec.get("seed") is None:
            spec["seed"] = int.from_bytes(os.urandom(4), "little")
        sticky_key = spec.pop("sticky_key", None)
        user_on_token = spec.pop("on_token", None)
        t0 = time.perf_counter()
        with self._lock:
            replica = self._pick(sticky_key, spec.get("adapter_id"))
            if replica is None:
                # backpressure, not an error: HTTP 503 + Retry-After at the
                # server, as an engine's full queue
                EVENT_LOG.emit("router", "router_queue_full",
                               reason="no_usable_replica",
                               replicas=len(self.replicas))
                raise QueueFull("no usable replica (all draining/dead)",
                                retry_after_s=self._retry_after_s())
            rr = _Routed(spec, user_on_token, sticky_key, None, replica)
            espec = dict(spec, on_token=_stream(rr, 0))
            [handle] = replica.engine.submit_many([espec])
            rr.handle = handle
            # the engine applied default_deadline_s: freeze the ABSOLUTE
            # deadline, so failover resubmits get the remaining budget
            rr.deadline = handle._req.deadline
            self._pending[id(rr)] = rr
            replica.dispatched += 1
            self.routed_total += 1
            if sticky_key is not None and self.config.sticky:
                self._sticky[sticky_key] = replica.id
            qd = len(replica.engine.queue)
        self.trace.add("route", t0, time.perf_counter(),
                       request_id=handle.rid,
                       args={"replica": replica.id, "queue_depth": qd})
        EVENT_LOG.emit("router", "routed", request_id=handle.rid,
                       replica=replica.id, queue_depth=qd)
        return RouterHandle(self, rr)

    def _pick(self, sticky_key: Optional[str],
              adapter_id: Optional[str] = None) -> Optional[Replica]:
        """The least-loaded usable replica (router lock held); a sticky
        key's replica while it is usable.  Health, then adapter affinity,
        then load."""
        usable = [r for r in self.replicas
                  if not r.draining and r.alive()]
        if not usable:
            return None
        if sticky_key is not None and self.config.sticky:
            rid = self._sticky.get(sticky_key)
            for r in usable:
                if r.id == rid:
                    return r
        burn = self.config.slo_max_burn
        return min(usable,
                   key=lambda r: (not r.healthy(burn),
                                  _no_affinity(r, adapter_id)) + r.load())

    # -- completion / failover --------------------------------------------

    def _settle(self, rr: _Routed) -> None:
        """The request's current attempt finished: complete it or fail it
        over.  Idempotent; callable from any thread."""
        with self._lock:
            if rr.done_event.is_set():
                return
            h = rr.handle
            if not h._req.done_event.is_set():
                return
            res = h._req.result
            if res is not None and res.finish_reason != "error":
                self._complete(rr, res)
                return
            self._failover(rr, f"scheduler error on {rr.replica.id}",
                           crashed=True)

    def _complete(self, rr: _Routed, res: FinishedRequest) -> None:
        rr.final = res
        rr.replica.completed += 1
        self.completed_total += 1
        self._pending.pop(id(rr), None)
        rr.done_event.set()

    def _fail(self, rr: _Routed, why: str) -> None:
        rr.failed = why
        self._pending.pop(id(rr), None)
        rr.done_event.set()

    def _quarantine(self, rr: _Routed, why: str) -> None:
        """Poison-request quarantine (router lock held): a request in
        flight at ``quarantine_after`` replica crashes is the prime suspect
        for causing them; it finishes "quarantined" (with the tokens
        generated so far) instead of going on to another replica."""
        req = rr.handle._req
        rr.attempt += 1  # fence any late tokens of the dead attempt
        rr.final = FinishedRequest(
            tokens=list(req.prompt) + list(req.generated),
            prompt_len=len(req.prompt), finish_reason="quarantined")
        self.quarantined_total += 1
        self._pending.pop(id(rr), None)
        rr.done_event.set()
        self.trace.add("quarantine", time.perf_counter(),
                       time.perf_counter(), request_id=rr.handle.rid,
                       args={"crashes": rr.crashes, "why": why})
        EVENT_LOG.emit("router", "request_quarantined",
                       request_id=rr.handle.rid, crashes=rr.crashes,
                       resubmits=rr.resubmits, reason=why)

    def _retry_after_s(self) -> float:
        """Retry-After of the router's backpressure: the largest engine
        hint behind it."""
        return max(r.engine.config.retry_after_s for r in self.replicas)

    def _failover(self, rr: _Routed, why: str, *,
                  crashed: bool = False) -> None:
        """Resubmit ``rr`` to another replica (router lock held).
        ``crashed`` marks a failover caused by a replica's crash (scheduler
        error, dead thread, kill), which counts toward the poison
        quarantine; a drain never does."""
        if rr.done_event.is_set():
            return
        old_rid = rr.handle.rid
        old_replica = rr.replica.id
        if crashed:
            rr.crashes += 1
            qa = self.config.quarantine_after
            if qa > 0 and rr.crashes >= qa:
                self._quarantine(rr, why)
                return
        if rr.resubmits >= self.config.max_resubmits:
            self._fail(rr, f"{why}; resubmit budget exhausted")
            return
        # the original wall-clock budget runs on across failovers: a
        # request whose budget is gone times out NOW instead of taking a
        # slot for a retry that is dead on arrival
        remaining = None
        if rr.deadline is not None:
            remaining = rr.deadline - time.perf_counter()
            if remaining <= 0:
                req = rr.handle._req
                self._complete(rr, FinishedRequest(
                    tokens=list(req.prompt) + list(req.generated),
                    prompt_len=len(req.prompt), finish_reason="timeout"))
                EVENT_LOG.emit("router", "failover_expired",
                               request_id=old_rid, replica=old_replica,
                               delivered_tokens=rr.delivered)
                return
        target = self._pick(None, rr.spec.get("adapter_id"))
        if target is None or target.id == old_replica:
            target = next((r for r in self.replicas
                           if r.id != old_replica and not r.draining
                           and r.alive()), target)
        if target is None:
            self._fail(rr, f"{why}; no usable replica left")
            return
        rr.resubmits += 1
        rr.attempt += 1  # fences late tokens of the old attempt
        self.failovers_total += 1
        # replay suppression: the tokens the client has stream again (same
        # seed, same trajectory) and are dropped by count
        rr.skip = rr.delivered
        t0 = time.perf_counter()
        # the original resolved spec: a resubmit keeps its priority class
        espec = dict(rr.spec, on_token=_stream(rr, rr.attempt))
        if remaining is not None:
            espec["deadline_s"] = remaining
        try:
            [handle] = target.engine.submit_many([espec])
        except Exception as e:  # noqa: BLE001 — the target refused
            self._fail(rr, f"{why}; resubmit refused: {e!r}")
            return
        rr.handle = handle
        rr.replica = target
        self._pending[id(rr)] = rr
        target.dispatched += 1
        self.resubmitted_total += 1
        if rr.sticky_key is not None and self.config.sticky:
            self._sticky[rr.sticky_key] = target.id
        self.trace.add("failover", t0, time.perf_counter(),
                       request_id=handle.rid,
                       args={"from": old_replica, "to": target.id,
                             "prev_rid": old_rid, "replayed": rr.skip})
        EVENT_LOG.emit("router", "resubmitted", request_id=handle.rid,
                       prev_request_id=old_rid, from_replica=old_replica,
                       to_replica=target.id, replayed_tokens=rr.skip,
                       priority=int(rr.spec.get("priority", 0)))

    # -- replica-level operations -----------------------------------------

    def drain_replica(self, replica_id: str,
                      timeout: Optional[float] = None, *,
                      wait: bool = True) -> bool:
        """Drain one replica: its queued (not yet started) requests move to
        the other replicas at once; in-flight streams finish in place."""
        r = self._replica(replica_id)
        t0 = time.perf_counter()
        with self._lock:
            r.draining = True
            moved = []
            for rr in list(self._pending.values()):
                if rr.replica is r and r.engine.queue.remove(rr.handle._req):
                    moved.append(rr)  # atomically ours: never admitted
            for rr in moved:
                self._failover(rr, f"{r.id} draining")
        EVENT_LOG.emit("router", "replica_draining", replica=r.id,
                       resubmitted=len(moved))
        timeout = (self.config.drain_timeout_s
                   if timeout is None else timeout)

        def _finish_drain() -> bool:
            ok = r.engine.drain(timeout)
            self.trace.add("drain", t0, time.perf_counter(),
                           args={"replica": r.id, "ok": ok,
                                 "resubmitted": len(moved)})
            EVENT_LOG.emit("router", "replica_drained", replica=r.id,
                           ok=ok, resubmitted=len(moved))
            return ok

        if wait:
            return _finish_drain()
        threading.Thread(target=_finish_drain, name=f"drain-{r.id}",
                         daemon=True).start()
        return True

    def kill_replica(self, replica_id: str, timeout: float = 10.0) -> int:
        """Hard-kill a replica (a crash, or a test's hook): shut its engine
        (a sharded replica's workers get ``stop``) and fail over every
        unfinished request it held → the number resubmitted."""
        r = self._replica(replica_id)
        with self._lock:
            r.dead = True
        r.engine.shutdown(timeout)  # joins the scheduler: no callback
        #                             races the resubmission
        EVENT_LOG.emit("router", "replica_dead", replica=r.id)
        with self._lock:
            orphans = [rr for rr in self._pending.values()
                       if rr.replica is r and not rr.done_event.is_set()]
            for rr in orphans:
                self._failover(rr, f"{r.id} killed", crashed=True)
        return len(orphans)

    def _replica(self, replica_id: str) -> Replica:
        for r in self.replicas:
            if r.id == replica_id:
                return r
        raise KeyError(f"unknown replica {replica_id!r}")

    # -- item 11 (c): adapters across replicas, shipments, migration -------

    def register_adapter(self, adapter_id: str, adapter) -> None:
        raise _item_c("Router.register_adapter (adapters across replicas)")

    def rolling_swap(self, new_params, timeout: Optional[float] = None):
        raise _item_c("Router.rolling_swap (it live-migrates decodes)")

    def migrate_request(self, request, to_replica_id: Optional[str] = None,
                        timeout: float = 30.0) -> bool:
        raise _item_c("Router.migrate_request (live KV migration)")

    def _wire_ship_handler(self, r: Replica) -> None:
        raise _item_c("the prefill replicas' ship handler")

    def _pick_decode(self, exclude: Optional[Replica] = None,
                     adapter_id: Optional[str] = None):
        raise _item_c("phase routing to decode replicas")

    def _dispatch_shipment(self, ship, src: Replica, src_engine=None):
        raise _item_c("a KV shipment between replicas")

    # -- health probe thread ----------------------------------------------

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.config.probe_interval_s):
            for r in self.replicas:
                if not r.dead and not r.alive():
                    with self._lock:
                        r.dead = True
                    EVENT_LOG.emit("router", "replica_dead", replica=r.id)
                    with self._lock:
                        for rr in list(self._pending.values()):
                            if rr.replica is r:
                                self._settle_dead(rr)
            # completion sweep: requests finish even when nobody waits in
            # result() (fire-and-forget streaming clients)
            for rr in list(self._pending.values()):
                if rr.handle._req.done_event.is_set():
                    self._settle(rr)

    def _settle_dead(self, rr: _Routed) -> None:
        """Dead-replica sweep (router lock held): engine-finished requests
        settle as usual, the rest fail over."""
        if rr.done_event.is_set():
            return
        res = rr.handle._req.result
        if rr.handle._req.done_event.is_set() and res is not None \
                and res.finish_reason != "error":
            self._complete(rr, res)
        else:
            self._failover(rr, f"{rr.replica.id} dead", crashed=True)

    # -- introspection (any thread; GET /cluster) --------------------------

    def snapshot(self) -> dict:
        burn = self.config.slo_max_burn
        roles: dict[str, int] = {}
        for r in self.replicas:
            roles[r.role] = roles.get(r.role, 0) + 1
        sup = self.supervisor
        replica_metrics = [r.engine.metrics.snapshot()
                           for r in self.replicas]
        return {
            "router": {
                "replicas": len(self.replicas),
                "usable": sum(1 for r in self.replicas
                              if not r.draining and r.alive()),
                "roles": roles,
                "draining": self._draining,
                "routed_total": self.routed_total,
                "resubmitted_total": self.resubmitted_total,
                "failovers_total": self.failovers_total,
                "completed_total": self.completed_total,
                "ships_total": self.ships_total,
                "migrations_total": self.migrations_total,
                "ship_bytes_total": self.ship_bytes_total,
                "rolling_swaps_total": self.rolling_swaps_total,
                "quarantined_total": self.quarantined_total,
                "replicas_rebuilt_total":
                    0 if sup is None else sup.rebuilt_total,
                "watchdog_trips_total":
                    0 if sup is None else sup.watchdog_trips_total,
                "pending": len(self._pending),
                "sticky_keys": len(self._sticky),
                # tiered-KV totals summed over the replicas
                **{k: sum(int(s.get(k, 0)) for s in replica_metrics)
                   for k in ("preemptions_total", "swap_out_blocks_total",
                             "swap_in_blocks_total", "swap_bytes_total")},
            },
            "shipments_in_flight": list(self._shipments.values()),
            "replicas": [r.probe(burn) for r in self.replicas],
        }

    def kv_snapshot(self) -> dict:
        return {r.id: r.engine.kv_snapshot() for r in self.replicas}


def _stream(rr: _Routed, attempt: int) -> Callable[[int], None]:
    """The on_token of one attempt: drops the replayed prefix after a
    failover and forwards the rest to the client's callback.  It is fenced
    by attempt: a stale attempt's late tokens are dropped, so the client's
    stream never sees a duplicate."""

    def on_token(tok: int) -> None:
        if rr.attempt != attempt:  # a stale attempt: fenced off
            return
        if rr.skip > 0:
            rr.skip -= 1
            return
        rr.delivered += 1
        if rr.user_on_token is not None:
            rr.user_on_token(tok)

    return on_token


class _RouterMetrics:
    """The engine metrics' shape: ``snapshot()`` for the JSON /metrics
    route, ``collect()`` registered as the ``"cluster"`` collector for the
    Prometheus scrape."""

    def __init__(self, router: Router):
        self._router = router

    @property
    def slo(self):
        # the first replica's tracker: the server-level question is "can
        # someone serve", not "is everyone pristine"
        return self._router.replicas[0].engine.metrics.slo

    def snapshot(self) -> dict:
        r = self._router
        out = r.snapshot()
        out["per_replica"] = {
            rep.id: rep.engine.metrics.snapshot() for rep in r.replicas}
        return out

    def collect(self) -> List[MetricFamily]:
        r = self._router
        sup = r.supervisor
        fams = [
            MetricFamily("cluster_replicas", "gauge",
                         "engine replicas behind the router"
                         ).add(len(r.replicas)),
            MetricFamily("cluster_replicas_usable", "gauge",
                         "replicas accepting dispatch"
                         ).add(sum(1 for x in r.replicas
                                   if not x.draining and x.alive())),
            MetricFamily("cluster_routed_total", "counter",
                         "requests dispatched").add(r.routed_total),
            MetricFamily("cluster_resubmitted_total", "counter",
                         "requests moved by failover"
                         ).add(r.resubmitted_total),
            MetricFamily("cluster_failovers_total", "counter",
                         "failover decisions").add(r.failovers_total),
            MetricFamily("cluster_completed_total", "counter",
                         "requests completed").add(r.completed_total),
            MetricFamily("cluster_ships_total", "counter",
                         "prefill->decode KV-block shipments"
                         ).add(r.ships_total),
            MetricFamily("cluster_migrations_total", "counter",
                         "live decode migrations").add(r.migrations_total),
            MetricFamily("cluster_rolling_swaps_total", "counter",
                         "completed rolling weight-swap deploys"
                         ).add(r.rolling_swaps_total),
            MetricFamily("cluster_ship_bytes_total", "counter",
                         "dense KV bytes shipped between replicas"
                         ).add(r.ship_bytes_total),
            MetricFamily("cluster_shipments_in_flight", "gauge",
                         "KV shipments currently owned by neither replica"
                         ).add(len(r._shipments)),
            MetricFamily("cluster_quarantined_requests_total", "counter",
                         "poison requests quarantined after repeated "
                         "crash correlation").add(r.quarantined_total),
            MetricFamily("cluster_replicas_rebuilt_total", "counter",
                         "replica incarnations rebuilt by the supervisor"
                         ).add(0 if sup is None else sup.rebuilt_total),
            MetricFamily("cluster_watchdog_trips_total", "counter",
                         "hung-step watchdog kills"
                         ).add(0 if sup is None
                               else sup.watchdog_trips_total),
        ]
        gen = MetricFamily("cluster_replica_generation", "gauge",
                           "per-replica incarnation counter")
        for rep in r.replicas:
            gen.add(rep.generation, labels={"replica": rep.id})
        fams.append(gen)
        qd = MetricFamily("cluster_replica_queue_depth", "gauge",
                          "per-replica queue depth")
        for rep in r.replicas:
            qd.add(len(rep.engine.queue), labels={"replica": rep.id})
        fams.append(qd)
        roles: dict[str, int] = {}
        for rep in r.replicas:
            roles[rep.role] = roles.get(rep.role, 0) + 1
        by_role = MetricFamily("cluster_replicas_by_role", "gauge",
                               "replicas per engine role")
        for role, n in sorted(roles.items()):
            by_role.add(n, labels={"role": role})
        fams.append(by_role)
        return fams
