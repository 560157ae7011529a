"""The port's observability primitives against the JAX package's, on the
CPU (mirror of ``tests/obs/test_registry.py``, ``test_slo.py`` and
``test_logging.py``, case for case).

Registry: each case runs the same call sequence on a JAX
``MetricsRegistry`` and on the port's, and the two ``prometheus_text()``
strings must be equal (character for character), besides the JAX test's
own assertions on the port's scrape through a minimal 0.0.4 parser.  SLO:
the same observations under the same fake clock give equal snapshots and
collector rows.  Event log: line shape, ring bounds, filters, the stream
sink (a dead one too), reconfiguration, and ``rank`` 0 without a process
group.
"""

import io
import json
import math
import re

import pytest

from megatron_llm_tpu.obs import registry as jreg
from megatron_llm_tpu.obs import slo as jslo
from megatron_llm_tpu_torch.obs import registry as treg
from megatron_llm_tpu_torch.obs import slo as tslo
from megatron_llm_tpu_torch.obs.logging import StructuredLog

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text):
    """Minimal 0.0.4 text-format parser → (types, samples); asserts on any
    line it cannot parse."""
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
        labels = {}
        if labelstr:
            consumed = sum(len(p) for p in
                           re.findall(r'[a-zA-Z_][a-zA-Z0-9_]*='
                                      r'"(?:[^"\\]|\\.)*",?', labelstr))
            assert consumed == len(labelstr), \
                f"unparseable label block: {labelstr!r}"
            for k, v in _LABEL_RE.findall(labelstr):
                labels[k] = (v.replace(r"\"", '"').replace(r"\n", "\n")
                             .replace("\\\\", "\\"))
        samples[(name, frozenset(labels.items()))] = float(value)
    return types, samples


def _both(build):
    """``build(module)`` on the JAX registry module and the port's: the
    port's registry, after asserting both scrape to the same text."""
    j, t = build(jreg), build(treg)
    assert t.prometheus_text() == j.prometheus_text()
    return t


# ---------------------------------------------------------------------------
# registry (tests/obs/test_registry.py)
# ---------------------------------------------------------------------------


def _counter_gauge(mod):
    reg = mod.MetricsRegistry()
    reg.counter("requests_total", "requests seen").inc(by=3)
    reg.counter("requests_total").inc()  # get-or-create: the same metric
    reg.gauge("queue_depth").set(7)
    reg.gauge("queue_depth").dec(2)
    return reg


def _labeled(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("events_total", "by kind", labelnames=("kind",))
    c.inc(kind="retry")
    c.inc(by=2, kind="rollback")
    return reg


def _histogram(mod):
    reg = mod.MetricsRegistry()
    h = reg.histogram("step_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    return reg


def _summary(mod):
    fam = mod.summary_family("ttft_seconds", "time to first token",
                             count=10, total=4.2,
                             quantiles={0.5: 0.3, 0.99: 1.7})
    reg = mod.MetricsRegistry()
    reg.register_collector("x", lambda: [fam])
    return reg


def _escaping(mod):
    reg = mod.MetricsRegistry()
    reg.gauge("weird", labelnames=("path",)).set(1.0, path='a"b\\c\nd')
    return reg


def _broken(mod):
    reg = mod.MetricsRegistry()
    reg.gauge("fine").set(1)

    def broken():
        raise RuntimeError("boom")

    reg.register_collector("bad", broken)
    return reg


def test_counter_gauge_round_trip():
    types, samples = parse_prometheus(_both(_counter_gauge).prometheus_text())
    assert types["requests_total"] == "counter"
    assert types["queue_depth"] == "gauge"
    assert samples[("requests_total", frozenset())] == 4.0
    assert samples[("queue_depth", frozenset())] == 5.0


def test_labeled_counter_children():
    reg = _both(_labeled)
    c = reg.counter("events_total", labelnames=("kind",))
    assert c.value(kind="retry") == 1.0
    _, samples = parse_prometheus(reg.prometheus_text())
    assert samples[("events_total", frozenset({("kind", "retry")}))] == 1.0
    assert samples[("events_total",
                    frozenset({("kind", "rollback")}))] == 2.0
    with pytest.raises(ValueError):
        c.inc(wrong="x")  # undeclared label name
    with pytest.raises(ValueError):
        c.inc(by=-1, kind="retry")  # counters only increase


def test_untouched_unlabeled_counter_exports_zero():
    reg = _both(lambda m: (lambda r: (r.counter("never_incremented_total"),
                                      r)[1])(m.MetricsRegistry()))
    _, samples = parse_prometheus(reg.prometheus_text())
    assert samples[("never_incremented_total", frozenset())] == 0.0


def test_type_mismatch_raises():
    reg = treg.MetricsRegistry()
    reg.counter("thing")
    with pytest.raises(ValueError):
        reg.gauge("thing")


def test_invalid_names_rejected():
    reg = treg.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("bad-name")
    with pytest.raises(ValueError):
        reg.counter("ok_name", labelnames=("bad-label",))


def test_histogram_cumulative_buckets():
    types, samples = parse_prometheus(_both(_histogram).prometheus_text())
    assert types["step_seconds"] == "histogram"

    def bucket(le):
        return samples[("step_seconds_bucket", frozenset({("le", le)}))]

    assert bucket("0.1") == 1.0
    assert bucket("1") == 3.0   # cumulative
    assert bucket("10") == 4.0
    assert bucket("+Inf") == 5.0
    assert samples[("step_seconds_count", frozenset())] == 5.0
    assert samples[("step_seconds_sum", frozenset())] == pytest.approx(56.05)


def test_summary_family_quantiles():
    types, samples = parse_prometheus(_both(_summary).prometheus_text())
    assert types["ttft_seconds"] == "summary"
    assert samples[("ttft_seconds", frozenset({("quantile", "0.5")}))] == 0.3
    assert samples[("ttft_seconds",
                    frozenset({("quantile", "0.99")}))] == 1.7
    assert samples[("ttft_seconds_count", frozenset())] == 10.0
    assert samples[("ttft_seconds_sum", frozenset())] == 4.2


def test_collector_replace_by_name():
    """Re-registering under one name replaces: the newest ServingMetrics is
    the one scraped."""
    def build(mod):
        reg = mod.MetricsRegistry()
        reg.register_collector(
            "serving", lambda: [mod.MetricFamily("v", "gauge").add(1.0)])
        reg.register_collector(
            "serving", lambda: [mod.MetricFamily("v", "gauge").add(2.0)])
        return reg

    reg = _both(build)
    _, samples = parse_prometheus(reg.prometheus_text())
    assert samples[("v", frozenset())] == 2.0
    reg.unregister_collector("serving")
    assert ("v", frozenset()) not in parse_prometheus(
        reg.prometheus_text())[1]


def test_broken_collector_does_not_kill_scrape():
    _, samples = parse_prometheus(_both(_broken).prometheus_text())
    assert samples[("fine", frozenset())] == 1.0
    err_keys = [k for k in samples if k[0] == "obs_collector_errors"]
    assert len(err_keys) == 1
    assert dict(err_keys[0][1])["collector"] == "bad"


def test_label_value_escaping_round_trips():
    _, samples = parse_prometheus(_both(_escaping).prometheus_text())
    assert samples[("weird", frozenset({("path", 'a"b\\c\nd')}))] == 1.0


@pytest.mark.parametrize("v", [3.0, 0.25, float("inf"), float("-inf"),
                               float("nan"), 1e20, -7.5])
def test_fmt_float(v):
    assert treg._fmt_float(v) == jreg._fmt_float(v)
    if math.isnan(v):
        assert math.isnan(float(treg._fmt_float(v)))
    else:
        assert float(treg._fmt_float(v)) == v


def test_reset_clears_everything():
    reg = treg.MetricsRegistry()
    reg.counter("a_total").inc()
    reg.register_collector("c", lambda: [treg.MetricFamily("b", "gauge")])
    reg.reset()
    assert reg.prometheus_text() == "\n"


# ---------------------------------------------------------------------------
# SLO tracker (tests/obs/test_slo.py)
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _trackers(**cfg):
    """A JAX and a port tracker on one fake clock."""
    clock = FakeClock()
    return (jslo.SLOTracker(jslo.SLOConfig(**cfg), clock=clock),
            tslo.SLOTracker(tslo.SLOConfig(**cfg), clock=clock), clock)


def _same(j, t):
    assert t.snapshot() == j.snapshot()
    for dim in tslo.SLOTracker.DIMENSIONS:
        assert t.compliance(dim) == j.compliance(dim)
        assert t.burn_rate(dim) == j.burn_rate(dim)


def test_empty_window_is_healthy():
    j, t, _ = _trackers()
    _same(j, t)
    for dim in tslo.SLOTracker.DIMENSIONS:
        assert t.compliance(dim) == 1.0 and t.burn_rate(dim) == 0.0
    assert t.healthy()
    snap = t.snapshot()
    assert snap["healthy"] and snap["ttft"]["total"] == 0


def test_ttft_compliance_and_burn():
    j, t, _ = _trackers(ttft_target_s=1.0, ttft_objective=0.9)
    for s in (0.5, 0.5, 0.5, 2.0):
        j.record_ttft(s)
        t.record_ttft(s)
    _same(j, t)
    assert t.compliance("ttft") == 0.75
    assert t.burn_rate("ttft") == pytest.approx(2.5)
    assert not t.healthy()


def test_itl_batch_weighting():
    j, t, _ = _trackers(itl_target_s=0.1, itl_objective=0.5)
    for tr in (j, t):
        tr.record_itl(0.05, n=8)
        tr.record_itl(0.5, n=8)
    _same(j, t)
    assert t.compliance("itl") == 0.5 and t.burn_rate("itl") == 1.0
    assert t.healthy()  # burn exactly 1.0 is the sustainable edge


def test_availability():
    j, t, _ = _trackers(availability_target=0.5)
    for tr in (j, t):
        tr.record_request(True)
        tr.record_request(False)
    _same(j, t)
    snap = t.snapshot()
    assert snap["availability"]["good"] == 1
    assert snap["availability"]["total"] == 2


def test_window_pruning():
    j, t, clock = _trackers(window_s=10.0)
    j.record_ttft(9.0)
    t.record_ttft(9.0)   # a miss at t=0
    clock.t = 5.0
    _same(j, t)
    assert t.compliance("ttft") == 0.0
    clock.t = 11.0       # the miss ages out of the window
    _same(j, t)
    assert t.compliance("ttft") == 1.0
    j.record_ttft(0.1)
    t.record_ttft(0.1)
    _same(j, t)
    assert t.snapshot()["ttft"]["total"] == 1


def test_snapshot_shape():
    j, t, _ = _trackers()
    j.record_ttft(0.1)
    t.record_ttft(0.1)
    _same(j, t)
    snap = t.snapshot()
    assert snap["window_s"] == 300.0
    assert snap["ttft"]["target_s"] == 1.0 and snap["itl"]["target_s"] == 0.25
    for dim in tslo.SLOTracker.DIMENSIONS:
        assert {"compliance", "burn_rate", "objective",
                "good", "total"} <= set(snap[dim])


def test_collect_families():
    j, t, _ = _trackers(ttft_objective=0.9)
    j.record_ttft(5.0)
    t.record_ttft(5.0)  # all misses: burn = 1 / 0.1
    rows = [[(f.name, f.mtype, [(s.suffix, s.labels, s.value)
                                for s in f.samples])
             for f in tr.collect(prefix="serving_slo")] for tr in (j, t)]
    assert rows[0] == rows[1]
    by_name = {f.name: f for f in t.collect(prefix="serving_slo")}
    assert set(by_name) == {"serving_slo_compliance",
                            "serving_slo_burn_rate", "serving_slo_healthy"}
    burn = {s.labels["slo"]: s.value
            for s in by_name["serving_slo_burn_rate"].samples}
    assert burn["ttft"] == pytest.approx(10.0) and burn["itl"] == 0.0
    assert by_name["serving_slo_healthy"].samples[0].value == 0.0


# ---------------------------------------------------------------------------
# structured event log (tests/obs/test_logging.py)
# ---------------------------------------------------------------------------


def test_emit_line_shape():
    log = StructuredLog()
    line = log.emit("engine", "first_token", request_id="req-9",
                    ttft_s=0.123)
    assert line["component"] == "engine" and line["event"] == "first_token"
    assert line["request_id"] == "req-9" and line["ttft_s"] == 0.123
    assert isinstance(line["ts"], float)
    assert line["rank"] == 0  # no process group in this process


def test_ring_bound_and_recent_filters():
    log = StructuredLog(capacity=4)
    for i in range(6):
        log.emit("engine", "submitted", request_id=f"req-{i}")
    log.emit("queue", "queue_full", depth=3)
    assert len(log.recent()) == 4  # the capacity bound
    assert log.recent(request_id="req-5")[0]["request_id"] == "req-5"
    assert log.recent(event="queue_full")[0]["depth"] == 3
    assert log.recent(request_id="req-0") == []  # evicted
    assert len(log.recent(limit=2)) == 2
    log.clear()
    assert log.recent() == []


def test_stream_sink_writes_json_lines():
    buf = io.StringIO()
    log = StructuredLog(stream=buf)
    log.emit("training", "log_window", iteration=5, lm_loss=2.5)
    parsed = json.loads(buf.getvalue())
    assert parsed["event"] == "log_window" and parsed["iteration"] == 5


def test_dead_stream_is_swallowed():
    class Dead:
        def write(self, _):
            raise OSError("broken pipe")

        def flush(self):
            raise OSError("broken pipe")

    log = StructuredLog(stream=Dead())
    assert log.emit("engine", "finished", request_id="req-1")["event"] == \
        "finished"
    assert log.recent()[-1]["event"] == "finished"  # the ring still has it


def test_configure_stream_and_capacity():
    log = StructuredLog(capacity=8)
    for i in range(8):
        log.emit("x", "e", i=i)
    log.configure(capacity=3)  # a shrink keeps the newest lines
    assert [line["i"] for line in log.recent()] == [5, 6, 7]
    buf = io.StringIO()
    log.configure(stream=buf)
    log.emit("x", "late")
    assert "late" in buf.getvalue()
    log.configure(stream=None)
    log.emit("x", "silent")
    assert "silent" not in buf.getvalue()


def test_non_serializable_fields_stringified():
    buf = io.StringIO()
    log = StructuredLog(stream=buf)
    log.emit("x", "e", path=object())  # default=str kicks in
    assert json.loads(buf.getvalue())["event"] == "e"
