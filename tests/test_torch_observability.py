"""The observability spine through the port's serving stack, against the
JAX package's, on the CPU (mirror of
``tests/serving/test_observability.py``, case for case):

- ``GET /metrics?format=prometheus`` serves serving counters and
  summaries, SLO gauges and the resilience family from one scrape of the
  shared registry, parseable as 0.0.4 text; after the same traffic the
  port's ``serving_*`` families are JAX's, type for type (less the serving
  cluster's shipment counters), with the same lifecycle counts;
- ``GET /metrics`` (JSON) keeps its shape;
- ``GET /trace`` is Chrome trace-event JSON where one request id links its
  queued → prefill → decode → retire spans;
- the structured event log, the trace spans and the HTTP response carry
  one ``request_id``;
- ``trace=False`` serves with an empty trace.

Config: the tiny preset at 1 layer and vocab 256, JAX's weights carried
across by ``params_from_jax``, a ``NullTokenizer``.
"""

import json
import re
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation.server import MegatronServer as JServer
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.tokenizer.tokenizer import NullTokenizer as JNull
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation.server import (
    GenerationService,
    MegatronServer,
)
from megatron_llm_tpu_torch.obs.logging import EVENT_LOG
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

CFG = dict(num_layers=1, vocab_size=256, make_vocab_size_divisible_by=8)
# the serving cluster's counters, which come with the cluster
CLUSTER_ONLY = {"serving_ships_out_total", "serving_ships_in_total",
                "serving_ship_failures_total"}

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """Minimal 0.0.4 parser → (types, samples); asserts on bad lines."""
    types, samples = {}, {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE"):
            _, _, name, mtype = line.split(maxsplit=3)
            types[name] = mtype.strip()
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable exposition line: {line!r}"
        name, labelstr, value = m.groups()
        labels = dict(_LABEL_RE.findall(labelstr)) if labelstr else {}
        samples[(name, frozenset(labels.items()))] = float(value)
    return types, samples


@pytest.fixture(scope="module")
def model():
    jc, tc = jtiny(**CFG), ttiny(**CFG)
    jp = jm.init_params(jax.random.key(0), jc)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _server(tc, tp, **kw):
    server = MegatronServer(tc, tp, NullTokenizer(vocab_size=tc.vocab_size),
                            max_batch_size=2, device="cpu", **kw)
    server.run("127.0.0.1", 0, block=False)
    return server


def _generate(port, prompts, ttg=4):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api",
        data=json.dumps({"prompts": prompts, "tokens_to_generate": ttg,
                         "no_early_termination": True}).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _scrape(port):
    url = f"http://127.0.0.1:{port}/metrics?format=prometheus"
    with urllib.request.urlopen(url, timeout=60) as resp:
        assert resp.status == 200
        ctype = resp.headers["Content-Type"]
        assert ctype.startswith("text/plain") and "version=0.0.4" in ctype
        return resp.read().decode()


def test_prometheus_endpoint_round_trip(model):
    """After real traffic the text endpoint carries serving counters,
    latency summaries, SLO gauges and the resilience family, and the
    port's serving families and lifecycle counts are the JAX server's."""
    jc, jp, tc, tp = model
    server = _server(tc, tp)
    try:
        out = _generate(server.port, ["5 9 3", "7 2"], ttg=4)
        text = _scrape(server.port)
    finally:
        server.shutdown()
    jserver = JServer(jc, jp, JNull(vocab_size=jc.vocab_size),
                      max_batch_size=2)
    jserver.run("127.0.0.1", 0, block=False)
    try:
        jout = _generate(jserver.port, ["5 9 3", "7 2"], ttg=4)
        jtext = _scrape(jserver.port)
    finally:
        jserver.shutdown()
    assert out["text"] == jout["text"]

    types, samples = parse_prometheus(text)
    assert types["serving_completed_total"] == "counter"
    assert samples[("serving_completed_total", frozenset())] == 2.0
    assert samples[("serving_submitted_total", frozenset())] == 2.0
    assert types["serving_ttft_seconds"] == "summary"
    assert samples[("serving_ttft_seconds_count", frozenset())] == 2.0
    assert ("serving_ttft_seconds",
            frozenset({("quantile", "0.5")})) in samples
    assert types["serving_slo_burn_rate"] == "gauge"
    for dim in ("ttft", "itl", "availability"):
        assert ("serving_slo_compliance",
                frozenset({("slo", dim)})) in samples
    assert samples[("serving_slo_healthy", frozenset())] in (0.0, 1.0)
    for name, kind in (("serving_blocks_free", "gauge"),
                       ("serving_blocks_used", "gauge"),
                       ("serving_kv_cache_util", "gauge"),
                       ("serving_cow_copies_total", "counter")):
        assert types[name] == kind
    assert samples[("serving_blocks_free", frozenset())] > 0
    assert samples[("serving_cow_copies_total", frozenset())] == 0.0
    assert types["resilience_events_total"] == "counter"

    jtypes, jsamples = parse_prometheus(jtext)
    mine = {n: t for n, t in types.items() if n.startswith("serving_")}
    theirs = {n: t for n, t in jtypes.items() if n.startswith("serving_")}
    assert set(theirs) - set(mine) == CLUSTER_ONLY
    assert mine == {n: t for n, t in theirs.items() if n not in CLUSTER_ONLY}
    for name in ("submitted", "admitted", "completed", "prefills",
                 "decode_tokens", "prefix_misses"):
        key = (f"serving_{name}_total", frozenset())
        assert samples[key] == jsamples[key], name


def test_json_metrics_shape_unchanged(model):
    """The JSON endpoint keeps its keys; Prometheus is opt-in through the
    query parameter."""
    _, _, tc, tp = model
    server = _server(tc, tp)
    try:
        _generate(server.port, ["5 9 3"], ttg=3)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics",
                timeout=60) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            snap = json.loads(resp.read())
    finally:
        server.shutdown()
    assert snap["completed"] == 1
    for key in ("submitted", "decode_iterations", "ttft",
                "per_token_latency", "device_idle_frac", "prefix_hit_rate",
                "blocks_free", "blocks_used", "kv_cache_util",
                "cow_copies_total", "step_routes", "timers_s"):
        assert key in snap
    assert snap["ttft"]["count"] == 1
    assert "p99_s" in snap["ttft"] and "total_count" in snap["ttft"]
    assert snap["slo"]["healthy"] in (True, False)


def test_trace_endpoint_schema_and_request_lifecycle(model):
    """GET /trace after a multi-request run: valid Chrome trace JSON, and
    each request id's queued → prefill → decode → retire spans."""
    _, _, tc, tp = model
    server = _server(tc, tp)
    try:
        out = _generate(server.port, ["5 9 3", "7 2", "11 12"], ttg=4)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/trace",
                timeout=60) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            trace = json.loads(resp.read())
    finally:
        server.shutdown()
    assert trace["displayTimeUnit"] == "ms"
    assert "dropped_events" in trace["otherData"]
    events = trace["traceEvents"]
    assert events
    for ev in events:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        assert ev["ph"] in ("X", "i")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    rids = out["request_ids"]
    assert len(rids) == 3 and len(set(rids)) == 3
    for rid in rids:
        ph = {e["name"] for e in events
              if e.get("args", {}).get("request_id") == rid}
        assert "queued" in ph, f"{rid}: {ph}"
        assert any(p == "prefill" or p.startswith("prefill_chunk")
                   for p in ph), f"{rid}: {ph}"
        assert "decode" in ph and "retire" in ph, f"{rid}: {ph}"
    steps = [e for e in events if e["name"] == "engine_step"]
    assert steps and all(e["args"]["batch"] >= 1 for e in steps)
    assert all(e["args"]["route"] in ("fused", "fallback") for e in steps)


@pytest.mark.parametrize("chunk", [None, 2])
def test_request_id_correlates_log_lines_and_spans(model, chunk):
    """One id, three views: the response's request_ids, the event log's
    lifecycle lines (through whole-prompt and chunked admission), and the
    trace spans."""
    _, _, tc, tp = model
    EVENT_LOG.clear()
    svc = GenerationService(tc, tp, NullTokenizer(vocab_size=tc.vocab_size),
                            max_batch_size=2, prefill_chunk=chunk,
                            device="cpu")
    try:
        status, out = svc.handle({"prompts": ["5 9 3"],
                                  "tokens_to_generate": 3,
                                  "no_early_termination": True})
        assert status == 200
        (rid,) = out["request_ids"]
        lines = EVENT_LOG.recent(request_id=rid)
        seen = [line["event"] for line in lines]
        for event in ("submitted", "admitted", "first_token", "finished",
                      "http_response"):
            assert event in seen, f"missing {event} in {seen}"
        admitted = next(l for l in lines if l["event"] == "admitted")
        assert admitted["chunked"] is (chunk is not None)
        finished = next(l for l in lines if l["event"] == "finished")
        assert finished["component"] == "engine"
        assert finished["reason"] in ("length", "eos")
        assert finished["generated"] == 3
        assert next(l for l in lines
                    if l["event"] == "first_token")["ttft_s"] > 0
        resp = next(l for l in lines if l["event"] == "http_response")
        assert resp["component"] == "server" and resp["status"] == 200
        span_rids = {e.get("args", {}).get("request_id")
                     for e in svc.engine.trace.chrome_trace()["traceEvents"]}
        assert rid in span_rids
    finally:
        svc.close()


def test_no_trace_escape_hatch(model):
    """trace=False: requests serve and /trace is empty but valid."""
    _, _, tc, tp = model
    svc = GenerationService(tc, tp, NullTokenizer(vocab_size=tc.vocab_size),
                            max_batch_size=2, trace=False, device="cpu")
    try:
        status, out = svc.handle({"prompts": ["5 9"],
                                  "tokens_to_generate": 3,
                                  "no_early_termination": True})
        assert status == 200 and len(out["text"]) == 1
        assert svc.trace_snapshot()["traceEvents"] == []
        assert not svc.engine.trace.enabled
    finally:
        svc.close()
