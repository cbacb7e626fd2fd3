"""The port's telemetry plane against the JAX package's ``deepdfa_tpu/obs``,
on the CPU: the same calls in the same order to both packages' objects.

- the metrics registry's exposition text, byte for byte, and a served
  ``ServeMetrics`` rendering of the same traffic;
- ``parse_traceparent`` on well-formed and malformed headers, the tracer's
  nesting, and ``chrome_trace``'s structure on the same span records;
- the SLO engine's verdicts, burn rates and transitions on an injected
  clock, its ``/slo`` body byte for byte, and ``alerts.json``;
- ``psi`` and the drift sentinel's snapshots on the same score streams;
- the flight recorder's ring and its dump's keys (the ``obs.flight_drop``
  and ``obs.trace_drop`` points count a drop and never raise);
- the invariant passes (``atomic``, ``locks``, ``metrics``) of the JAX
  package's analysis over the port: no finding.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from deepdfa_tpu import obs as jobs
from deepdfa_tpu.resilience import faults as jfaults
from deepdfa_tpu.serve.metrics import ServeMetrics as JServeMetrics

from deepdfa_tpu_torch import obs
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.serve.metrics import ServeMetrics

REPO = Path(__file__).resolve().parent.parent


def _stage(pkg):
    reg = pkg.MetricsRegistry("deepdfa_test_")
    c = reg.counter("requests_total", "Requests", labels=("code",))
    c.set(3, code=200)
    c.inc(2, code=500)
    c.inc(code=200)
    reg.gauge("ratio", "A ratio").set(0.125)
    reg.gauge("big", "A whole float").set(3.0)
    reg.gauge("none", "Never staged").set(None)
    reg.gauge("inf", "Infinity").set(float("inf"))
    lab = reg.gauge("escaped", "Label escaping", labels=("v",))
    lab.set(1, v='a"b\\c\nd')
    h = reg.histogram("lat", "Latency", buckets=[1, 5, 10], labels=("q",))
    for v in (0.5, 3, 3, 7, 11):
        h.observe(v, q="x")
    h.set_histogram([1, 2, 0], 4.5, 3, q="y")
    reg.counter("requests_total", "Requests", labels=("code",)).inc(
        code=404)
    return reg


def test_registry_exposition_is_byte_for_byte_jax():
    assert _stage(obs).render() == _stage(jobs).render()
    for pkg in (obs, jobs):
        reg = pkg.MetricsRegistry()
        reg.counter("x", "X")
        with pytest.raises(ValueError, match="already declared"):
            reg.gauge("x", "X")
        with pytest.raises(ValueError, match="expected labels"):
            reg.counter("y", "Y", labels=("a",)).set(1, b=2)
        with pytest.raises(TypeError, match="not a histogram"):
            reg.counter("x", "X").observe(1.0)
    assert obs.escape_label_value('a"\n\\') == jobs.escape_label_value(
        'a"\n\\')


def _traffic(m):
    m.inc("requests_total", 5)
    for code, ms in ((200, 10.0), (200, 30.0), (400, 1.0), (503, 2.0)):
        m.observe_response(code, ms)
    m.inc("dropped_total")
    m.observe_batch(3, 16)
    m.observe_batch(16, 16)
    m.observe_padding(126, real={"nodes": 50, "edges": 90, "graphs": 3},
                      padded={"nodes": 2048, "edges": 8192, "graphs": 17})
    m.inc("cascade_escalated_total", 2)
    m.inc("cascade_degraded_total")
    m.observe_answered(1)
    m.observe_answered(2)
    for r in (m.queue_wait, m.dispatch, m.tier1_latency, m.tier2_latency,
              m.frontend_encode):
        for v in (1.0, 2.0, 9.0):
            r.observe(v)
    m.set_gauge("queue_depth", 4)
    m.set_warmup({"buckets": 3, "per_bucket": {
        "126": {"source": "compile", "compile_seconds": 1.5}}})
    return m.render({"hits": 2, "encode_hits": 1, "misses": 3,
                     "evictions": 0, "entries": 4, "hit_rate": 1 / 3})


def test_serve_metrics_render_the_jax_bytes_less_the_deferred_families():
    got, want = _traffic(ServeMetrics(64)), _traffic(JServeMetrics(64))
    # no family is deferred any more: admission and brownout render too
    deferred = ()
    keep = [line for line in want.splitlines()
            if not any(f"deepdfa_serve_{d}" in line for d in deferred)]
    assert got.splitlines() == keep == want.splitlines()
    assert any(line.startswith("deepdfa_serve_brownout_level")
               for line in keep)
    assert ServeMetrics(8).snapshot().keys() == \
        JServeMetrics(8).snapshot().keys()


@pytest.mark.parametrize("header", [
    None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
    " 00-" + "1" * 32 + "-" + "2" * 16 + "-03 ",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01", "garbage"])
def test_parse_traceparent_equals_jax(header):
    got, want = obs.parse_traceparent(header), jobs.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.sampled) == (
            want.trace_id, want.span_id, want.sampled)
        assert got.traceparent() == want.traceparent()


def test_tracer_nesting_and_chrome_trace_structure():
    tracer = obs.Tracer(proc="serve", max_spans=3)
    with tracer.span("root", root=True, a=1) as root:
        with tracer.span("child") as child:
            assert tracer.current().span_id == child.span_id
        tracer.record("queue.wait", root.start_s, parent=root.ctx, bucket=2)
    spans = tracer.spans()
    assert [s.name for s in spans] == ["child", "queue.wait", "root"]
    assert {s.trace_id for s in spans} == {root.trace_id}
    assert spans[0].parent_id == root.span_id and root.parent_id is None
    with tracer.span("extra"):
        pass
    assert len(tracer) == 3 and tracer.recorded_total == 4  # bounded
    records = [s.to_record() for s in spans]
    records[1]["proc"] = "router"
    got, want = obs.chrome_trace(records), jobs.chrome_trace(records)
    assert got == want
    assert [e["ph"] for e in got["traceEvents"]] == ["M", "X", "M", "X", "X"]
    with faults.installed("obs.trace_drop@1"):
        with tracer.span("dropped"):
            pass
    assert tracer.dropped_total == 1


def _slo_run(pkg, clock):
    eng = pkg.SLOEngine(pkg.serve_specs(p99_ms=100.0, tier2_p99_ms=500.0),
                        fast_window_s=60.0, slow_window_s=600.0,
                        burn_threshold=2.0, clock=clock)
    out = []
    snap = {"responses_total": 0, "responses_5xx_total": 0,
            "responses_error_total": 0, "latency_p99_ms": 50.0,
            "drift_alerting": 0, "tier2_latency_p99_ms": None,
            "cascade_escalated_total": 0, "cascade_degraded_total": 0}
    for step in range(40):
        clock.t += 30.0
        snap["responses_total"] += 100
        if 10 <= step < 25:  # an incident: 10 % 5xx and slow
            snap["responses_5xx_total"] += 10
            snap["responses_error_total"] += 12
            snap["latency_p99_ms"] = 400.0
            snap["drift_alerting"] = 1
        else:
            snap["latency_p99_ms"] = 50.0
            snap["drift_alerting"] = 0
        snap["cascade_escalated_total"] += 4
        snap["cascade_degraded_total"] += step % 2
        snap["tier2_latency_p99_ms"] = 100.0 + step
        out.append((eng.observe(dict(snap)), eng.statuses()))
    out.append(eng.render("deepdfa_serve_"))
    eng.observe({"responses_total": "bad"})  # never raises
    out.append(eng.dropped_total)
    return out


class _Clock:
    def __init__(self):
        self.t = 1_000_000.0

    def __call__(self):
        return self.t


def test_slo_verdicts_and_burn_rates_equal_jax(tmp_path):
    got, want = _slo_run(obs, _Clock()), _slo_run(jobs, _Clock())
    assert got == want
    fired = [e for events, _ in got[:-2] for e in events]
    assert {e["slo"] for e in fired if e["state"] == "firing"} >= {
        "availability", "latency_p99", "score_drift"}
    assert any(e["state"] == "resolved" for e in fired)
    statuses = got[-3][1]
    clock = _Clock()
    a = obs.write_alerts_artifact(tmp_path / "a" / "alerts.json", statuses,
                                  clock=clock)
    b = jobs.write_alerts_artifact(tmp_path / "b" / "alerts.json", statuses,
                                   clock=clock)
    assert a.read_text() == b.read_text()
    with pytest.raises(ValueError, match="duplicate"):
        obs.SLOEngine(obs.serve_specs() + obs.serve_specs()[:1])
    with pytest.raises(ValueError, match="ratio SLO"):
        obs.SLOSpec("x", "ratio", 0.5)


def test_psi_and_drift_verdicts_equal_jax():
    import numpy as np

    ref = [0, 5, 9, 3, 0, 0, 1, 2, 7, 4]
    cur = [1, 4, 9, 2, 1, 0, 3, 2, 5, 6]
    assert obs.psi(ref, cur) == jobs.psi(ref, cur)
    assert obs.psi(ref, ref) == 0.0
    with pytest.raises(ValueError, match="mismatch"):
        obs.psi([1], [1, 2])
    snaps = []
    for pkg in (obs, jobs):
        s = pkg.ScoreDriftSentinel(window=64, bins=10, threshold=0.2,
                                   min_samples=32, max_revs=2)
        local = np.random.default_rng(1)
        out = []
        for i in range(300):
            shift = 0.0 if i < 150 else 0.45
            s.observe(float(np.clip(local.beta(2, 5) + shift, 0, 1)), "r1")
            if i % 3 == 0:
                s.observe(float(local.uniform()), "r2")
            if i == 200:
                s.observe(0.5, "r3")  # evicts the coldest rev
            if i % 50 == 49:
                out.append(s.snapshot())
        snaps.append((out, s.evicted_revs_total))
    assert snaps[0] == snaps[1]
    final = snaps[0][0][-1]
    assert final["r1"]["alert"] is True and snaps[0][1] >= 1
    assert len(final) == 2  # max_revs


def test_flight_recorder_dump_keys_equal_jax(tmp_path):
    dumps = []
    for pkg, registry, name in ((obs, faults, "port"), (jobs, jfaults, "jax")):
        clock = _Clock()
        rec = pkg.FlightRecorder(capacity=3, proc="serve",
                                 dump_dir=tmp_path / name, clock=clock)
        for i in range(5):
            clock.t += 1.0
            assert rec.record("request", code=200, i=i)
        with registry.installed("obs.flight_drop@1"):
            assert rec.record("dropped") is False
        path = rec.dump("engine_error")
        doc = json.loads(path.read_text())
        dumps.append((path.name, doc))
        with pytest.raises(ValueError, match="capacity"):
            pkg.FlightRecorder(capacity=0)
    (pname, port), (jname, jax_doc) = dumps
    assert pname == jname and port == jax_doc
    assert sorted(port) == ["capacity", "dropped_total", "dumped_at_unix",
                            "events", "proc", "reason", "recorded_total",
                            "schema"]
    assert [e["i"] for e in port["events"]] == [2, 3, 4]
    assert port["dropped_total"] == 1


def test_invariant_passes_find_nothing_in_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "deepdfa_tpu.analysis", "deepdfa_tpu_torch",
         "--no-baseline", "--passes", "atomic,locks,metrics"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout + proc.stderr
