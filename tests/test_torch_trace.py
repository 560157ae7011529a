"""Span tracing in the port (``obs/trace.py``), against the JAX package's
``TraceRecorder``, on the CPU: the recorder's behaviour (mirror of
``tests/obs/test_trace.py``), the Chrome trace-event schema event for
event beside JAX's for the same spans, and the engine's spans through GET
/trace under the JAX names and args.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.obs.trace import TraceRecorder as JTraceRecorder
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import MegatronServer
from megatron_llm_tpu_torch.obs.trace import TraceRecorder, device_annotation
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)


def test_span_records_complete_event():
    tr = TraceRecorder()
    with tr.span("prefill", request_id="req-1", tid=1,
                 args={"prompt_len": 64}):
        pass
    trace = tr.chrome_trace()
    assert trace["displayTimeUnit"] == "ms"
    assert trace["otherData"]["dropped_events"] == 0
    (ev,) = trace["traceEvents"]
    assert ev["name"] == "prefill" and ev["ph"] == "X"
    assert ev["tid"] == 1 and ev["pid"] > 0
    assert ev["ts"] >= 0 and ev["dur"] >= 0
    assert ev["args"] == {"prompt_len": 64, "request_id": "req-1"}
    json.dumps(trace)


def test_instant_event_schema():
    tr = TraceRecorder()
    tr.instant("retire", request_id="req-2", tid=2, args={"reason": "eos"})
    (ev,) = tr.chrome_trace()["traceEvents"]
    assert ev["ph"] == "i" and ev["s"] == "t"
    assert "dur" not in ev
    assert ev["args"] == {"reason": "eos", "request_id": "req-2"}


def test_ring_drops_oldest_and_counts():
    tr = TraceRecorder(capacity=3)
    for i in range(5):
        tr.add(f"s{i}", 0.0, 1.0)
    trace = tr.chrome_trace()
    assert [e["name"] for e in trace["traceEvents"]] == ["s2", "s3", "s4"]
    assert trace["otherData"]["dropped_events"] == 2
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_disabled_recorder_is_inert():
    tr = TraceRecorder(enabled=False)
    ran = []
    with tr.span("x", annotate=True):
        ran.append(1)
    tr.add("y", 0.0, 1.0)
    tr.instant("z")
    assert ran == [1]
    assert tr.chrome_trace()["traceEvents"] == []


def test_span_records_even_when_body_raises():
    tr = TraceRecorder()
    with pytest.raises(RuntimeError):
        with tr.span("failing", request_id="req-3"):
            raise RuntimeError("x")
    (ev,) = tr.chrome_trace()["traceEvents"]
    assert ev["name"] == "failing"


def test_device_annotation_is_a_null_context_on_the_cpu():
    for dev in (None, "cpu", torch.device("cpu")):
        with device_annotation("decode", dev):
            pass


def test_negative_duration_clamped():
    tr = TraceRecorder()
    tr.add("clock_skew", 2.0, 1.0)
    (ev,) = tr.chrome_trace()["traceEvents"]
    assert ev["dur"] == 0


def _record(tr):
    tr.add("queued", 1.0, 1.5, request_id="req-7", tid=7,
           args={"prompt_len": 9})
    tr.add("prefix_match", 1.5, 1.5001, request_id="req-7", tid=7,
           args={"hit": True, "matched_tokens": 8})
    tr.instant("retire", request_id="req-7", tid=7,
               args={"slot": 0, "reason": "length"})
    tr.add("engine_step", 2.0, 2.25, tid=0,
           args={"batch": 2, "route": "fused", "pipelined": True})


def test_chrome_trace_schema_matches_jax():
    """The same spans through both recorders: the same events, keys,
    phases, tids and args; timestamps differ only by the epochs."""
    got, want = TraceRecorder(), JTraceRecorder()
    _record(got)
    _record(want)
    g, w = got.chrome_trace(), want.chrome_trace()
    assert g.keys() == w.keys()
    assert g["displayTimeUnit"] == w["displayTimeUnit"]
    assert g["otherData"] == w["otherData"]
    for ge, we in zip(g["traceEvents"], w["traceEvents"], strict=True):
        assert ge.keys() == we.keys()
        for k in ge:
            if k not in ("ts", "pid"):
                assert ge[k] == we[k], k
    offs = [ge["ts"] - we["ts"] for ge, we in
            zip(g["traceEvents"], w["traceEvents"]) if ge["ph"] == "X"]
    np.testing.assert_allclose(offs, offs[0], atol=1e-3)


# ---------------------------------------------------------------------------
# The engine's spans
# ---------------------------------------------------------------------------


SLICE = dict(max_batch_size=2, max_seq_len=64, prefill_bucket=4,
             pipeline_decode=False)


@pytest.fixture(scope="module")
def weights():
    jc, tc = jtiny(fused_decode=False), ttiny(fused_decode=False)
    jp = jm.init_params(jax.random.key(0), jc)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _spans(engine, prompts):
    engine.start()
    try:
        for p in prompts:   # one at a time: the second hits the first
            engine.submit(p, 3, use_eos_stop=False).result(300)
    finally:
        engine.shutdown()
    # read once the scheduler thread has been joined: a request's result
    # resolves inside the step whose engine_step span is added after it
    return engine.trace.chrome_trace()["traceEvents"]


def _summary(events):
    """Per request, its spans in order as (name, phase, args without the
    request id); then the engine_step spans that carried a batch, in
    order, by their args (route, batch, pipelined).  Neither depends on
    how the scheduler thread's iterations fell against the client's."""
    requests, steps = {}, []
    for ev in events:
        args = dict(ev.get("args", {}))
        rid = args.pop("request_id", None)
        if ev["name"] == "engine_step":
            if args.get("batch"):
                steps.append(json.dumps(args, sort_keys=True))
            continue
        requests.setdefault(rid, []).append(
            (ev["name"], ev["ph"], json.dumps(args, sort_keys=True)))
    return list(requests.values()), steps


def test_engine_spans_match_jax(weights):
    """Both engines, the same two requests one after the other (the
    second a prefix hit), sync decode: each request's spans with the same
    names, phases and args in the same order, and the same batched
    engine_step spans."""
    jc, jp, tc, tp = weights
    rng = np.random.default_rng(3)
    a = rng.integers(1, 250, 10).tolist()
    prompts = [a, a[:8] + [7, 7]]
    want = _spans(JServingEngine(jc, jp, JEngineConfig(**SLICE)), prompts)
    got = _spans(ServingEngine(tc, tp, EngineConfig(**SLICE), device="cpu"),
                 prompts)
    got_requests, got_steps = _summary(got)
    want_requests, want_steps = _summary(want)
    assert len(want_requests) == 2 and len(want_steps) == 4
    assert got_requests == want_requests
    assert got_steps == want_steps
    names = {ev["name"] for ev in got}
    assert {"queued", "prefix_match", "prefill", "decode", "retire",
            "engine_step"} <= names


def test_trace_off_records_nothing(weights):
    _, _, tc, tp = weights
    engine = ServingEngine(tc, tp, EngineConfig(**SLICE, trace=False),
                           device="cpu")
    assert _spans(engine, [[1, 2, 3]]) == []


def test_get_trace(weights):
    """GET /trace: empty before the engine exists, then the engine's
    Chrome trace with its prefix_match spans."""
    _, _, tc, tp = weights
    server = MegatronServer(tc, tp, NullTokenizer(tc.vocab_size),
                            device="cpu", max_batch_size=2,
                            engine_max_seq_len=64, prefill_bucket=4)
    server.run("127.0.0.1", 0, block=False)

    def get():
        url = f"http://127.0.0.1:{server.port}/trace"
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    try:
        assert get() == (200, {"traceEvents": [], "displayTimeUnit": "ms",
                               "otherData": {"dropped_events": 0}})
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/api", method="PUT",
            data=json.dumps({"prompts": ["5 6 7 8 9"],
                             "tokens_to_generate": 2}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
        status, trace = get()
    finally:
        server.shutdown()
    assert status == 200
    match = [e for e in trace["traceEvents"] if e["name"] == "prefix_match"]
    assert len(match) == 1 and match[0]["args"]["hit"] is False
