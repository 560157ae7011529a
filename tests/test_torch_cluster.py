"""Engine replicas behind the router (``serving/cluster/router.py``,
``sharded.build_cluster``) against the JAX package (mirror of
``tests/serving/test_cluster.py``'s router cases and
``tests/serving/test_selfheal.py``'s router backpressure and
deadline-aware failover).

JAX's tiny fp32 config, its weights converted with
``convert.params_from_jax``, CPU engines.  Greedy tokens through the
router equal JAX's single-chip engine's (one module-scoped JAX run);
where JAX holds a failover against an uninterrupted run, the port holds
its router against its own uninterrupted engine, token for token and
stream for stream (exact: a resubmitted request replays its seed).  The
sharded replicas (2 x tp = 2) run in one gloo world of 3 ranks, the
router's process leading both (``tests/torch_world.py``'s
``cluster_serving_case``).
"""

import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.parallel import mesh as jmesh
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu.serving import build_cluster as jbuild_cluster
from megatron_llm_tpu_torch import checkpointing
from megatron_llm_tpu_torch.config import ParallelConfig, RuntimeConfig
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation.server import GenerationService
from megatron_llm_tpu_torch.obs.logging import EVENT_LOG
from megatron_llm_tpu_torch.parallel import mesh as mesh_lib
from megatron_llm_tpu_torch.serving import (
    EngineConfig,
    QueueFull,
    Router,
    RouterConfig,
    ServingEngine,
    build_cluster,
    build_disagg_cluster,
)
from megatron_llm_tpu_torch.tokenizer import NullTokenizer
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs

import torch_world

torch.set_num_threads(1)

KW = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8)
ENGINE = dict(max_batch_size=2, max_seq_len=64, max_queue_size=32,
              prefill_bucket=16)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, KW["vocab_size"],
                         int(rng.integers(4, 12))).tolist()
            for _ in range(n)]


def _specs(n, seed, new, **kw):
    return [dict(prompt=p, max_new_tokens=new, seed=i, use_eos_stop=False,
                 **kw) for i, p in enumerate(_prompts(n, seed))]


GREEDY = _specs(4, 11, 8)
SAMPLED = [dict(s, temperature=0.8, top_k=8) for s in GREEDY]


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.key(0), jtiny(**KW))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def jax_greedy(jparams):
    """JAX's single-chip engine's tokens for ``GREEDY``."""
    engine = JServingEngine(jtiny(**KW), jparams,
                            JEngineConfig(**ENGINE)).start()
    try:
        return [list(h.result(120).tokens)
                for h in engine.submit_many(GREEDY)]
    finally:
        engine.shutdown()


def _run(engine_or_router, specs, timeout=120):
    return [h.result(timeout) for h in engine_or_router.submit_many(specs)]


def _reference(params, specs, **over):
    """The port's uninterrupted single engine: the failover baseline."""
    engine = ServingEngine(ttiny(**KW), params,
                           EngineConfig(**dict(ENGINE, **over)),
                           device="cpu").start()
    try:
        return [list(r.tokens) for r in _run(engine, specs)]
    finally:
        engine.shutdown()


def _cluster(params, replicas=2, router_config=None, **over):
    return build_cluster(ttiny(**KW), params,
                         EngineConfig(**dict(ENGINE, **over)),
                         replicas=replicas, router_config=router_config,
                         device="cpu")


# ---------------------------------------------------------------------------
# the partition, the surface, what stays refused
# ---------------------------------------------------------------------------


def test_replica_submeshes_disjoint():
    """JAX gives each of 2 tp = 2 replicas its own slice of 2 devices; the
    port gives each 2 ranks, the router's rank 0 first in both and the
    others disjoint (the world of ``1 + R (n - 1)``), and refuses with
    JAX's messages."""
    jmeshes = jmesh.replica_submeshes(JPar(tensor_parallel=2), 2)
    jslices = [[d.id for d in m.devices.flatten()] for m in jmeshes]
    lists = mesh_lib.replica_ranks(ParallelConfig(tensor_parallel=2), 2,
                                   range(3))
    assert [len(r) for r in lists] == [len(s) for s in jslices] == [2, 2]
    assert [r[0] for r in lists] == [0, 0]
    assert not set(lists[0][1:]) & set(lists[1][1:])
    assert mesh_lib.replica_ranks(ParallelConfig(), 3, range(1)) == \
        [[0], [0], [0]]
    for fn, arg in ((jmesh.replica_submeshes, JPar(tensor_parallel=8)),
                    (mesh_lib.replica_submeshes,
                     ParallelConfig(tensor_parallel=8))):
        with pytest.raises(ValueError, match="need .* devices, have"):
            fn(arg, 2)
        with pytest.raises(ValueError, match="replicas must be >= 1"):
            fn(arg, 0)


def test_snapshot_and_probe_keys_equal_jax(jparams, params):
    """``Router.snapshot()``, ``Replica.probe()``, the metrics facade and
    ``GenerationService.cluster_snapshot()`` have JAX's keys, before and
    after serving."""
    jr = jbuild_cluster(jtiny(**KW), jparams, JEngineConfig(**ENGINE),
                        replicas=2)
    tr = _cluster(params)
    try:
        for serve in (False, True):
            if serve:
                _run(tr, GREEDY[:2])
            js, ts = jr.snapshot(), tr.snapshot()
            assert set(ts) == set(js)
            assert set(ts["router"]) == set(js["router"])
            assert [set(p) for p in ts["replicas"]] == \
                [set(p) for p in js["replicas"]]
            assert set(ts["replicas"][0]["slo"]) == \
                set(js["replicas"][0]["slo"])
        assert set(tr.metrics.snapshot()) == set(jr.metrics.snapshot())
    finally:
        tr.shutdown()
        jr.shutdown()
    svc = GenerationService(ttiny(**KW), params, NullTokenizer(64),
                            max_batch_size=2, engine_max_seq_len=64,
                            device="cpu")
    assert svc.cluster_snapshot() == {"router": None, "replicas": []}
    svc.close()


def test_item_c_stays_refused(params):
    """Shipments, live migration, rolling swaps and the cluster's adapters
    raise naming item 11 (c)."""
    router = _cluster(params)
    try:
        for call in (lambda: router.register_adapter("a", None),
                     lambda: router.rolling_swap(params),
                     lambda: router.migrate_request("req-1")):
            with pytest.raises(NotImplementedError, match=r"item 11 \(c\)"):
                call()
    finally:
        router.shutdown()
    with pytest.raises(NotImplementedError, match=r"item 11 \(c\)"):
        build_cluster(ttiny(**KW), params, replicas=2, adapters=object(),
                      device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 11 \(c\)"):
        build_disagg_cluster(ttiny(**KW), params)


# ---------------------------------------------------------------------------
# dispatch, stickiness, backpressure
# ---------------------------------------------------------------------------


def test_router_spreads_load_and_honors_sticky(params, jax_greedy):
    """Greedy tokens through 2 replicas equal JAX's single-chip engine's;
    an idle cluster splits a 4-burst over both; one sticky key keeps
    landing on one replica."""
    router = _cluster(params).start()
    try:
        got = [list(r.tokens) for r in _run(router, GREEDY)]
        assert got == jax_greedy
        snap = router.snapshot()
        assert snap["router"]["routed_total"] == 4
        assert snap["router"]["completed_total"] == 4
        assert all(r["dispatched"] >= 1 for r in snap["replicas"])
        sticky = [dict(prompt=GREEDY[0]["prompt"], max_new_tokens=4,
                       seed=9, use_eos_stop=False, sticky_key="conv-1")
                  for _ in range(3)]
        hs = router.submit_many(sticky)
        replicas = {h._rr.replica.id for h in hs}
        for h in hs:
            h.result(120)
        assert len(replicas) == 1
    finally:
        router.shutdown()
    routed = EVENT_LOG.recent(event="routed")
    assert routed and {e["replica"] for e in routed[-7:]} == \
        {"replica-0", "replica-1"}
    assert {s["name"] for s in router.trace.chrome_trace()["traceEvents"]
            if s.get("ph") == "X"} == {"route"}


def test_router_rejects_when_all_draining(params):
    router = _cluster(params).start()
    try:
        router.drain(timeout=60)
        with pytest.raises(QueueFull):
            router.submit_many([dict(prompt=[1, 2, 3], max_new_tokens=2)])
    finally:
        router.shutdown()


def test_router_queue_full_surfaces_as_503(params):
    svc = GenerationService(ttiny(**KW), params, NullTokenizer(64),
                            max_batch_size=2, engine_max_seq_len=64,
                            replicas=2, router=True, device="cpu")
    try:
        svc.engine.drain(timeout=60)  # every replica draining
        EVENT_LOG.clear()
        status, resp = svc.handle({"prompts": ["3 4 5"],
                                   "tokens_to_generate": 4})
        assert status == 503
        assert resp["retry_after"] >= 1
        assert "draining" in resp["message"]
        full = EVENT_LOG.recent(event="router_queue_full")
        assert full and full[-1]["reason"] == "draining"
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# failover: drain, kill, a dead scheduler, deadlines
# ---------------------------------------------------------------------------


def _streamed(router, specs):
    streams = {i: [] for i in range(len(specs))}
    handles = router.submit_many([
        dict(s, on_token=(lambda i: (lambda t: streams[i].append(int(t))))(
            i)) for i, s in enumerate(specs)])
    return handles, streams


def _streaming_on(handles, streams, replica_id, timeout=60.0):
    """Wait until a request on ``replica_id`` has streamed a token: decode
    runs there, and with one slot a replica its other requests queue."""
    mine = [i for i, h in enumerate(handles)
            if h._rr.replica.id == replica_id]
    t0 = time.perf_counter()
    while not any(streams[i] for i in mine):
        assert time.perf_counter() - t0 < timeout, "no token streamed"
        time.sleep(0.002)


def _check_streams(results, streams, ref):
    assert [list(r.tokens) for r in results] == ref
    for i, r in enumerate(results):
        assert streams[i] == list(map(int, r.tokens[r.prompt_len:]))


def test_drain_replica_mid_stream_loses_nothing(params):
    """Draining replica-0 with requests queued on it (one slot a replica)
    resubmits them to replica-1: every result and client stream equals
    the uninterrupted run, the ledgers balance, and the EVENT_LOG lines
    link each hop."""
    base = _prompts(4, seed=3)
    specs = [dict(prompt=base[i % 4], max_new_tokens=24, seed=i,
                  use_eos_stop=False) for i in range(6)]
    ref = _reference(params, specs)
    EVENT_LOG.clear()
    router = _cluster(params, max_batch_size=1, sanitize=True).start()
    try:
        handles, streams = _streamed(router, specs)
        _streaming_on(handles, streams, "replica-0")
        assert router.drain_replica("replica-0", timeout=120)
        results = [h.result(120) for h in handles]
    finally:
        for rep in router.replicas:
            assert rep.engine.sanitizer_report == []
        router.shutdown()
    _check_streams(results, streams, ref)
    drained = EVENT_LOG.recent(event="replica_drained")
    assert drained and drained[-1]["replica"] == "replica-0"
    routed_ids = {e["request_id"] for e in EVENT_LOG.recent(event="routed")}
    moved = EVENT_LOG.recent(event="resubmitted")
    assert moved
    for e in moved:
        assert e["request_id"] and e["prev_request_id"] in routed_ids
        assert e["from_replica"] == "replica-0"
    assert "drain" in {s["name"] for s in
                       router.trace.chrome_trace()["traceEvents"]}


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_kill_replica_mid_stream_loses_nothing(params, sampling):
    """Killing replica-0 mid-stream resubmits its requests with their
    seeds: greedy and sampled results and client streams equal the
    uninterrupted run (the replayed prefix is suppressed)."""
    base = _prompts(4, seed=5)
    extra = {} if sampling == "greedy" else dict(temperature=0.8, top_k=8)
    specs = [dict(prompt=base[i % 4], max_new_tokens=24, seed=i,
                  use_eos_stop=False, **extra) for i in range(6)]
    ref = _reference(params, specs)
    EVENT_LOG.clear()
    router = _cluster(params, max_batch_size=1).start()
    try:
        handles, streams = _streamed(router, specs)
        _streaming_on(handles, streams, "replica-0")
        moved = router.kill_replica("replica-0")
        assert moved >= 1, "the kill should orphan in-flight requests"
        results = [h.result(120) for h in handles]
        snap = router.snapshot()["router"]
    finally:
        router.shutdown()
    _check_streams(results, streams, ref)
    assert EVENT_LOG.recent(event="replica_dead")
    assert snap["failovers_total"] >= moved and snap["usable"] == 1
    assert "failover" in {s["name"] for s in
                          router.trace.chrome_trace()["traceEvents"]}


def test_probe_thread_detects_dead_scheduler(params):
    """A replica whose scheduler stops under the router (not through
    kill_replica) is found by the probe and its requests fail over."""
    specs = _specs(2, 7, 8)
    ref = _reference(params, specs)
    router = _cluster(params, max_batch_size=1,
                      router_config=RouterConfig(probe_interval_s=0.02)
                      ).start()
    try:
        victim = router.replicas[1]
        handles = router.submit_many(specs)
        victim.engine.shutdown(timeout=30)
        assert [list(h.result(120).tokens) for h in handles] == ref
        assert victim.dead
    finally:
        router.shutdown()


def test_failover_expires_dead_budget_instead_of_resubmitting(params):
    """A crash found after the request's budget ran out finishes it with
    ``timeout`` rather than resubmitting it."""
    router = _cluster(params, router_config=RouterConfig(
        probe_interval_s=0.5)).start()
    try:
        [h] = router.submit_many([dict(prompt=[1, 2, 3, 4],
                                       max_new_tokens=58, deadline_s=0.25,
                                       seed=0, use_eos_stop=False)])
        victim = h._rr.replica
        victim.engine.shutdown(timeout=30)
        assert h.result(120).finish_reason == "timeout"
        assert router.snapshot()["router"]["resubmitted_total"] == 0
        exp = EVENT_LOG.recent(event="failover_expired")
        assert exp and exp[-1]["replica"] == victim.id
    finally:
        router.shutdown()


def test_failover_passes_remaining_deadline(params):
    """A resubmit carries the original absolute deadline, not a fresh
    one."""
    router = _cluster(params, router_config=RouterConfig(
        probe_interval_s=0.02)).start()
    try:
        [h] = router.submit_many([dict(prompt=[1, 2, 3, 4],
                                       max_new_tokens=40, deadline_s=120.0,
                                       seed=0, use_eos_stop=False)])
        rr = h._rr
        original = rr.deadline
        assert original is not None
        router.kill_replica(rr.replica.id)
        if not rr.done_event.is_set():
            assert rr.handle._req.deadline == pytest.approx(original,
                                                            abs=1.0)
        assert h.result(120).finish_reason in ("length", "eos")
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# the server's surface
# ---------------------------------------------------------------------------


def test_generation_service_cluster_surface(params):
    svc = GenerationService(ttiny(**KW), params, NullTokenizer(64),
                            max_batch_size=2, engine_max_seq_len=64,
                            replicas=2, router=True, device="cpu")
    try:
        status, resp = svc.handle({"prompts": ["3 4 5", "6 7 8"],
                                   "tokens_to_generate": 4,
                                   "random_seed": 7})
        assert status == 200
        assert len(resp["text"]) == 2 and resp["request_ids"]
        snap = svc.cluster_snapshot()
        assert snap["router"]["replicas"] == 2
        assert snap["router"]["completed_total"] == 2
        assert {r["id"] for r in snap["replicas"]} == \
            {"replica-0", "replica-1"}
        assert all(r["alive"] for r in snap["replicas"])
        assert "router" in svc.metrics_snapshot()
        assert "cluster_routed_total 2" in svc.prometheus_metrics()
    finally:
        svc.close()


def test_single_engine_cluster_snapshot(params):
    svc = GenerationService(ttiny(**KW), params, NullTokenizer(64),
                            max_batch_size=2, engine_max_seq_len=64,
                            device="cpu")
    try:
        assert svc.cluster_snapshot() == {"router": None, "replicas": []}
        status, _ = svc.handle({"prompts": ["3 4 5"],
                                "tokens_to_generate": 2})
        assert status == 200
        snap = svc.cluster_snapshot()
        assert snap["router"] is None
        assert snap["replicas"][0]["alive"]
    finally:
        svc.close()


@pytest.fixture(scope="module")
def release(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    checkpointing.save_release_params(str(root), params,
                                      RuntimeConfig(model=ttiny(**KW)))
    return str(root)


CLI_BODY = {"prompts": ["3 14 15 9 2 6", "5 35 8 9", "7 7 1"],
            "tokens_to_generate": 7}


def _cli_argv(root, *flags):
    return ["--load", root, "--use_checkpoint_args", "--tokenizer_type",
            "null", "--max_batch_size", "2", "--max_seq_len", "64",
            "--prefill_bucket", "8", "--kv_block_size", "8",
            "--max_tokens_to_generate", "32", "--metrics_interval_s", "0",
            "--device", "cpu", "--host", "127.0.0.1", "--port", "0", *flags]


def _serve_once(argv):
    """``main(argv)`` on a thread: PUT /api ``CLI_BODY`` and GET /cluster,
    then a graceful shutdown → ``(texts, cluster, rc)``."""
    ready, box = threading.Event(), {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", rtgs.main(argv, on_ready=on_ready)))
    thread.start()
    try:
        assert ready.wait(120), "the server did not start"
        url = f"http://127.0.0.1:{box['server'].port}"
        req = urllib.request.Request(
            f"{url}/api", data=json.dumps(CLI_BODY).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            texts = json.loads(resp.read())["text"]
        with urllib.request.urlopen(f"{url}/cluster", timeout=60) as resp:
            cluster = json.loads(resp.read())
    finally:
        if "server" in box:
            box["server"].graceful_shutdown(10.0)
        thread.join(60)
    assert not thread.is_alive()
    return texts, cluster, box.get("rc")


@pytest.fixture(scope="module")
def one_engine_texts(release):
    return _serve_once(_cli_argv(release))[0]


@pytest.mark.parametrize("flags,replicas", [
    (["--replicas", "2"], 2), (["--router"], 1)], ids=["replicas2", "router"])
def test_server_entry_serves_through_the_router(release, one_engine_texts,
                                                flags, replicas):
    """``run_text_generation_server --replicas 2`` (and ``--router`` over
    one replica) answers PUT /api with the one-engine server's texts; GET
    /cluster lists every replica alive with its dispatch count."""
    texts, cluster, rc = _serve_once(_cli_argv(release, *flags))
    assert texts == one_engine_texts and rc == 0
    assert cluster["router"]["replicas"] == replicas
    assert [r["alive"] for r in cluster["replicas"]] == [True] * replicas
    assert sum(r["dispatched"] for r in cluster["replicas"]) == \
        len(CLI_BODY["prompts"])


def test_server_entry_refuses_sharded_replicas_without_a_world(release):
    """``--replicas 2 --tp 2`` in a world of one raises, naming the
    launcher, as ``--tp 2`` does."""
    with pytest.raises(ValueError, match="torchrun"):
        rtgs.main(_cli_argv(release, "--replicas", "2", "--tp", "2"))


# ---------------------------------------------------------------------------
# sharded replicas: 2 x tp = 2 in one world of 3 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(jparams, tmp_path_factory):
    meta = dict(model=("tiny_config", KW), engine=ENGINE,
                parallel=dict(tensor_parallel=2), replicas=2,
                batches=[GREEDY, SAMPLED], fault=2, fault_batch=SAMPLED)
    [out] = torch_world.run_world(
        3, tmp_path_factory.mktemp("cluster"),
        [("cluster_serving_case",
          {"params": jax.tree.map(np.asarray, jparams)}, meta)])
    return json.loads(str(out["result"]))


def test_sharded_replicas_behind_router(world, jax_greedy):
    """2 replicas x tp = 2: greedy tokens equal JAX's single-chip engine's,
    both replicas served, each decodes in one group, rank 0 leads both
    meshes and their worker ranks are disjoint."""
    (tokens, streams), _ = world["batches"]
    assert tokens == jax_greedy
    assert all(n >= 1 for n in world["dispatched"])
    assert world["groups"] == [1, 1]
    assert world["mesh_ranks"] == [[0, 1], [0, 2]]
    assert world["worker_ranks"] == [[0, 1], [0, 2]]


def test_sharded_worker_fault_fails_over(world):
    """Replica 1's worker raising in its decode fails replica 1 alone: the
    router resubmits its requests to replica 0, every sampled result and
    client stream equals the uninterrupted cluster's, and every rank
    returns (the faulty worker with its own error)."""
    want_tokens, want_streams = world["batches"][1]
    tokens, streams = world["fault_batch"]
    assert tokens == want_tokens and streams == want_streams
    assert world["fault_snapshot"]["resubmitted_total"] >= 1
    assert world["fault_alive"] == [True, False]
    assert world["worker_raised"] == [None, None, "injected worker fault"]
