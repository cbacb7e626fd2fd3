"""The port's admission control and brownout (``deepdfa_tpu_torch/serve/
admission.py``) against the JAX package's, on the CPU.

The JAX module imports no JAX, so both run side by side here:

- ``TokenBucket``, ``AdmissionController`` and ``BrownoutController`` of
  both packages on the same fake clock, burn script and request sequence
  give equal decisions, Retry-After values, summaries and journal and
  flight events, key for key (exact: both are the same float arithmetic);
- each ``admission.*`` fault point degrades to a 429 with a Retry-After or
  to a brownout transition, never to a 5xx, through both servers;
- both servers with admission on, behind engines whose weights
  ``bridge.flax_to_torch`` carries across, on the same clock: equal codes
  and bodies, scores within ``ATOL`` (the serve tests' 1e-5), equal
  ``/healthz`` keys and admission samples in ``/metrics``;
- the promotion controller's brownout gate against a real port server
  forced to level 1 through ``admission.brownout_force``: refused with
  ``gate="brownout"`` and journaled, and passing again at level 0.

Clocks are injected and the brownout thread never polls on its own (an
hour's interval): every transition is a ``poll_once`` the test makes.
"""

import contextlib
import dataclasses
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import AdmissionConfig as JAdmissionConfig  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import ServeConfig as JServeConfig  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.serve import ScoreServer as JServer  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import admission as jadm  # noqa: E402
from deepdfa_tpu.serve import serve_buckets as jserve_buckets  # noqa: E402
from deepdfa_tpu.serve.metrics import ServeMetrics as JServeMetrics  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, AdmissionConfig,  # noqa: E402
                                      GGNNConfig, ServeConfig)
from deepdfa_tpu_torch.continual.promote import PromotionController  # noqa: E402
from deepdfa_tpu_torch.continual.shadow import SCHEMA  # noqa: E402
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.obs.slo import write_alerts_artifact  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine, serve_buckets  # noqa: E402
from deepdfa_tpu_torch.serve import admission as tadm  # noqa: E402
from deepdfa_tpu_torch.serve.metrics import ServeMetrics  # noqa: E402
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402

SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
INPUT_DIM = JFeatureConfig().input_dim
ATOL = 1e-5  # the serve tests' tolerance on a live engine's scores
# both packages: (admission module, its config class, its metrics class,
# its fault registry)
PKGS = {"jax": (jadm, JAdmissionConfig, JServeMetrics, jfaults),
        "torch": (tadm, AdmissionConfig, ServeMetrics, faults)}
HOUR = 3600.0  # a brownout poll interval no test waits out


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _Journal:
    """A journal sink that keeps every record, or raises on each write."""

    def __init__(self, broken=False):
        self.records, self.broken = [], broken

    def write(self, **fields):
        if self.broken:
            raise OSError("journal disk gone")
        self.records.append(fields)


class _Flight:
    def __init__(self):
        self.events = []

    def record(self, name, **fields):
        self.events.append((name, fields))


@contextlib.contextmanager
def _armed(spec):
    """``spec`` armed in both packages' fault registries."""
    if not spec:
        yield
        return
    with faults.installed(spec), jfaults.installed(spec):
        yield


# ---------------------------------------------------------------- buckets


@pytest.mark.parametrize("rate,burst", [(1.0, 4.0), (2.5, 1.0),
                                        (50.0, 50.0), (0.3, 2.0)])
def test_token_bucket_equals_jax(rate, burst):
    rng = np.random.default_rng(int(rate * 10 + burst))
    steps = [(float(rng.choice([0.0, 0.1, 0.37, 1.0, 2.5])),
              float(rng.choice([1.0, 1.0, 2.0, 0.5]))) for _ in range(60)]
    out = {}
    for pkg, (mod, *_) in PKGS.items():
        clock = _Clock()
        bucket = mod.TokenBucket(rate, burst, clock=clock)
        seen = []
        for i, (dt, n) in enumerate(steps):
            clock.t += dt
            if i % 17 == 16:
                bucket.drain()
            seen.append((bucket.try_take(n), bucket.tokens(),
                         bucket.retry_after_s(n)))
        out[pkg] = seen
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("rate,burst", [(0.0, 1.0), (1.0, 0.0)])
def test_token_bucket_refuses_what_jax_refuses(rate, burst):
    for mod, *_ in PKGS.values():
        with pytest.raises(ValueError, match="rate and burst"):
            mod.TokenBucket(rate, burst)


# ------------------------------------------------------------- admission

ADMISSION_KW = dict(enabled=True, interactive_rate=2.0, interactive_burst=3.0,
                    batch_rate=0.5, batch_burst=2.0,
                    interactive_deadline_ms=500.0, batch_deadline_ms=2000.0,
                    depth_shed_factor=2.0)

# (clock step, tenant, class) — bursts past both budgets, refills, two
# tenants with buckets of their own
REQUESTS = ([(0.0, "a", "interactive")] * 5 + [(0.0, "a", "batch")] * 4
            + [(0.6, "a", "interactive"), (0.6, "a", "batch")] * 3
            + [(0.0, "b", "interactive")] * 4 + [(3.0, "b", "batch")] * 3)


def _admission_run(pkg, level=0, queue_waits=(), depth=0, spec=None,
                   broken_journal=False, requests=REQUESTS):
    mod, cfg_cls, metrics_cls, _ = PKGS[pkg]
    clock, journal, flight = _Clock(), _Journal(broken_journal), _Flight()
    metrics = metrics_cls(64)
    for ms in queue_waits:
        metrics.frontend_queue_wait.observe(ms)
    metrics.frontend_queue_depth = depth
    ctl = mod.AdmissionController(cfg_cls(**ADMISSION_KW), metrics=metrics,
                                  journal=journal, flight=flight, clock=clock)
    if level:
        ctl.brownout = type("Level", (), {"level": level})()
    decisions = []
    with _armed(spec):
        for dt, tenant, klass in requests:
            clock.t += dt
            decisions.append(ctl.admit(tenant, klass))
    snap = metrics.snapshot()
    return {"decisions": decisions, "summary": ctl.summary(),
            "journal": journal.records, "flight": flight.events,
            "metrics": {k: snap[k] for k in ("admission_admitted",
                                             "admission_shed")}}


@pytest.mark.parametrize("case", [
    dict(),
    dict(level=1), dict(level=2), dict(level=3),
    dict(queue_waits=[100.0] * 40 + [900.0] * 10),  # interactive deadline
    dict(queue_waits=[3000.0] * 20),  # both deadlines blown
    dict(depth=5),  # the depth guard binds batch only
    dict(spec="admission.bucket_exhausted@2,7"),
    dict(spec="admission.deadline_blown@1,3:seed=1"),
    dict(spec="admission.deadline_blown:p=0.5:seed=4"),
    dict(broken_journal=True),
], ids=["plain", "level1", "level2", "level3", "interactive_deadline",
        "both_deadlines", "depth", "bucket_fault", "deadline_fault",
        "deadline_fault_p", "broken_journal"])
def test_admission_decisions_equal_jax(case):
    got, want = _admission_run("torch", **case), _admission_run("jax", **case)
    assert got == want
    # a shed is always a 429's material: a reason and a whole Retry-After
    for d in got["decisions"]:
        assert d["admit"] or (d["reason"] in ("brownout", "bucket_exhausted",
                                              "deadline_blown")
                              and d["retry_after_s"] >= 1)
    if case.get("broken_journal"):
        assert got["summary"]["journal_drops"] == got["summary"]["shed_total"]


def test_batch_sheds_before_interactive():
    """Under the same pressure on both classes, batch (the smaller
    budget) sheds first."""
    mixed = [(0.0, "a", "interactive"), (0.0, "a", "batch")] * 4
    out = _admission_run("torch", requests=mixed)
    assert out == _admission_run("jax", requests=mixed)
    sheds = [d for d in out["decisions"] if not d["admit"]]
    assert [d["class"] for d in sheds] == ["batch", "interactive", "batch"]
    at3 = _admission_run("torch", level=3)["summary"]
    assert at3["shed"]["interactive"] == len(
        [r for r in REQUESTS if r[2] == "interactive"])
    assert at3["interactive_sheds_before_brownout"] == 0


# -------------------------------------------------------------- brownout

BROWNOUT_KW = dict(enabled=True, burn_high=2.0, burn_low=0.5,
                   up_consecutive=2, down_consecutive=3, cooldown_s=5.0,
                   poll_interval_s=HOUR, max_level=3)
# (clock step, burn): up streaks, a dead-band dip, cooldowns, the ceiling,
# a None scrape, the way down to 0
BURNS = ([(1.0, 3.0)] * 2 + [(1.0, 1.0)] + [(1.0, 3.0)] * 3
         + [(6.0, 3.0)] * 2 + [(6.0, 9.0)] * 4 + [(1.0, None)] * 2
         + [(6.0, 0.1)] * 12 + [(1.0, 0.2)] * 3)


def _brownout_run(pkg, burns=BURNS, spec=None, broken_journal=False,
                  **cfg_kw):
    mod, cfg_cls, metrics_cls, _ = PKGS[pkg]
    clock, journal, flight = _Clock(), _Journal(broken_journal), _Flight()
    metrics = metrics_cls(64)
    script = iter(b for _, b in burns)
    ctl = mod.BrownoutController(cfg_cls(**{**BROWNOUT_KW, **cfg_kw}),
                                 lambda: next(script), metrics=metrics,
                                 journal=journal, flight=flight, clock=clock)
    made, levels = [], []
    with _armed(spec):
        for dt, _ in burns:
            clock.t += dt
            made.append(ctl.poll_once())
            levels.append((ctl.level, ctl.level_name))
    snap = metrics.snapshot()
    return {"made": made, "levels": levels, "summary": ctl.summary(),
            "journal": journal.records, "flight": flight.events,
            "metrics": {k: snap[k] for k in (
                "brownout_level", "brownout_transitions_total")}}


@pytest.mark.parametrize("case", [
    dict(), dict(max_level=1), dict(max_level=2, cooldown_s=1.0),
    dict(up_consecutive=1, down_consecutive=1),
    dict(spec="admission.brownout_force@3,4"),
    dict(spec="admission.brownout_force"),  # every poll: to the ceiling
    dict(broken_journal=True),
], ids=["plain", "max1", "max2", "streaks1", "force", "force_always",
        "broken_journal"])
def test_brownout_transitions_equal_jax(case):
    got, want = _brownout_run("torch", **case), _brownout_run("jax", **case)
    assert got == want
    seen = [lv for lv, _ in got["levels"]]
    assert max(seen) == case.get("max_level", 3)
    if "spec" not in case:
        assert seen[-1] == 0  # the ladder comes back down
    if case.get("broken_journal"):
        assert got["summary"]["journal_drops"] == \
            got["summary"]["transitions_total"] > 0


def test_brownout_force_is_journaled_as_injected():
    out = _brownout_run("torch", burns=[(1.0, 0.0)] * 3,
                        spec="admission.brownout_force@2")
    assert [t["reason"] for t in out["summary"]["transitions"]] == [
        "fault_injected"]
    assert out["journal"][0]["event"] == "brownout_transition"
    assert out["flight"][0][0] == "brownout.transition"


# ------------------------------------------------------------ the servers


@pytest.fixture(scope="module")
def demo():
    rows = demo_corpus(6, seed=0).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, jvocabs = CorpusBuilder(JFeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    tvocabs = {k: Vocabulary.from_dict(v.to_dict()) for k, v in jvocabs.items()}
    return jvocabs, tvocabs, [r["before"] for r in rows]


@pytest.fixture(scope="module")
def live(demo):
    """A JAX GGNN's parameters and the same parameters as a port state
    dict (``bridge.flax_to_torch``)."""
    jv, _, sources = demo
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    g = jencode(sources[0], jv)[0].graph
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 64, 256))
    params = jmodel.init(jax.random.key(3), example)["params"]
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 GGNNConfig(**SMALL, layout="fused"),
                                 INPUT_DIM)
    return jmodel, params, state


def _stub_engines(demo):
    jv, tv, _ = demo
    fn = lambda batch: np.full(batch.max_graphs, 0.25, np.float32)  # noqa: E731
    return (JEngine(fn, jserve_buckets(4), feat_keys=tuple(jv)),
            ScoringEngine(fn, serve_buckets(4), feat_keys=tuple(tv)))


def _live_engines(live):
    jmodel, params, state = live
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=4)
    teng = ScoringEngine.from_model(
        make_model(GGNNConfig(**SMALL, layout="fused"), INPUT_DIM,
                   device="cpu"),
        state, "graph", feat_keys=KEYS, max_batch=4, device="cpu")
    return jeng, teng


def _on_clock(srv, clock):
    """Both controllers of ``srv`` on ``clock`` (set before any request:
    buckets are made on first use)."""
    srv.admission._clock = clock
    srv.admission._t0 = clock()
    if srv.brownout is not None:
        srv.brownout._clock = clock
        srv.brownout._t0 = clock()


@contextlib.contextmanager
def _servers(demo, engines, clock, **adm):
    jv, tv, _ = demo
    kw = dict(port=0, max_wait_ms=2.0)
    jeng, teng = engines
    jsrv = JServer(jeng, jv, JServeConfig(**kw, admission=JAdmissionConfig(
        **{**ADMISSION_KW, **BROWNOUT_KW, **adm})))
    tsrv = ScoreServer(teng, tv, ServeConfig(**kw, admission=AdmissionConfig(
        **{**ADMISSION_KW, **BROWNOUT_KW, **adm})))
    for srv in (jsrv, tsrv):
        _on_clock(srv, clock)
        srv.start()
    try:
        yield jsrv, tsrv
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def _post(port, payload):
    """``(status, body, Retry-After header)`` of one ``/score``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/score", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), resp.getheader(
            "Retry-After")
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _admission_samples(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith(("deepdfa_serve_admission_",
                                      "deepdfa_serve_brownout_")))


def _same_rows(got, want):
    assert got[0] == want[0]
    if got[0] != 200:
        assert got[1:] == want[1:]
        return
    assert got[1].keys() == want[1].keys() and got[2] == want[2]
    rows = zip(got[1]["results"], want[1]["results"], strict=True)
    for a, b in rows:
        assert a.keys() == b.keys() and a["function"] == b["function"]
        assert a["vulnerable_probability"] == pytest.approx(
            b["vulnerable_probability"], abs=ATOL)


def test_live_servers_with_admission_answer_alike(demo, live):
    _, _, sources = demo
    clock = _Clock()
    traffic = ([("a", "interactive", s) for s in sources]
               + [("a", "batch", s + f"\n// {i}\n") for i, s in
                  enumerate(sources)]
               + [("b", "interactive", sources[0]),  # a cache hit
                  ("b", "interactive", "int f( {{{ not C at all")])
    with _servers(demo, _live_engines(live), clock) as (jsrv, tsrv):
        for tenant, klass, src in traffic:
            clock.t += 0.05
            payload = {"source": src, "class": klass, "tenant": tenant}
            want, got = _post(jsrv.port, payload), _post(tsrv.port, payload)
            if got[0] == 422:
                assert want[0] == 422
                continue
            _same_rows(got, want)
            if got[0] == 429:
                assert got[2] == str(got[1]["retry_after_s"])
        for path in ("/healthz",):
            (js, jb), (ts, tb) = _get(jsrv.port, path), _get(tsrv.port, path)
            jb, tb = json.loads(jb), json.loads(tb)
            assert ts == js and tb.keys() == jb.keys()
            assert {k: tb[k] for k in ("admission", "brownout_level",
                                       "brownout")} == {
                k: jb[k] for k in ("admission", "brownout_level",
                                   "brownout")} == {
                "admission": True, "brownout_level": 0, "brownout": "normal"}
        assert _admission_samples(_get(tsrv.port, "/metrics")[1]) == \
            _admission_samples(_get(jsrv.port, "/metrics")[1])
        jsum, tsum = jsrv.admission.summary(), tsrv.admission.summary()
        assert tsum == jsum and tsum["shed"].get("batch")


@pytest.mark.parametrize("point", ["admission.bucket_exhausted",
                                   "admission.deadline_blown"])
def test_admission_faults_shed_as_429_in_both_servers(demo, point):
    _, _, sources = demo
    clock = _Clock()
    # a budget that refills between requests: only the fault sheds
    with _servers(demo, _stub_engines(demo), clock, interactive_rate=100.0,
                  interactive_burst=100.0) as (jsrv, tsrv):
        answers = []
        with _armed(f"{point}@2,3"):
            for i, src in enumerate(sources[:4]):
                clock.t += 0.05
                payload = {"source": src + f"\n// {i}\n"}
                answers.append((_post(jsrv.port, payload),
                                _post(tsrv.port, payload)))
    codes = []
    for want, got in answers:
        assert got == want
        codes.append(got[0])
        if got[0] == 429:
            assert got[2] == str(got[1]["retry_after_s"]) and \
                got[1]["reason"] == point.split(".")[1]
    assert codes == [200, 429, 429, 200]


def test_brownout_force_degrades_the_ladder_never_a_5xx(demo):
    _, _, sources = demo
    clock = _Clock()
    with _servers(demo, _stub_engines(demo), clock) as (jsrv, tsrv):
        seen = []
        for level in (1, 2, 3):
            with _armed("admission.brownout_force@1"):
                for srv in (jsrv, tsrv):
                    srv.brownout.poll_once()
            clock.t += 0.05
            out = []
            for srv in (jsrv, tsrv):
                health = json.loads(_get(srv.port, "/healthz")[1])
                out.append((health["brownout_level"], health["brownout"],
                            _post(srv.port, {"source": sources[level],
                                             "class": "batch"})[:2],
                            _post(srv.port, {"source": sources[level]})[0]))
            assert out[0] == out[1]
            seen.append(out[1])
    assert [s[0] for s in seen] == [1, 2, 3]
    assert [s[1] for s in seen] == ["shed_batch", "cache_tier1_only",
                                    "shed_interactive"]
    assert all(s[2][0] == 429 and s[2][1]["reason"] == "brownout"
               for s in seen)
    assert [s[3] for s in seen] == [200, 200, 429]


def test_promotion_brownout_gate_reads_a_real_server(demo, tmp_path):
    """A port server forced to level 1 refuses the promotion with
    ``gate="brownout"`` (journaled); back at level 0 the gate passes."""
    _, tv, sources = demo
    clock = _Clock()
    _, teng = _stub_engines(demo)
    srv = ScoreServer(teng, tv, ServeConfig(
        port=0, max_wait_ms=2.0,
        admission=AdmissionConfig(**{**ADMISSION_KW, **BROWNOUT_KW})))
    _on_clock(srv, clock)
    srv.start()
    journal = _Journal()
    alerts = write_alerts_artifact(tmp_path / "alerts.json", [])
    shadow = {"schema": SCHEMA, "pass": True}
    target = f"127.0.0.1:{srv.port}"
    pc = PromotionController(None, None, None, candidate_rev="b",
                             prior_rev="a", alerts_path=alerts,
                             journal=journal, brownout_targets=[target])
    try:
        with faults.installed("admission.brownout_force@1"):
            srv.brownout.poll_once()
        assert json.loads(_get(srv.port, "/healthz")[1])[
            "brownout_level"] == 1
        refused = pc.check_gates(shadow)
        assert refused["action"] == "refused" and \
            refused["gate"] == "brownout"
        assert refused["brownout_level"] == 1 and refused["target"] == target
        assert journal.records[-1]["event"] == "promotion_transition"
        assert journal.records[-1]["gate"] == "brownout"
        # recovery: clean traffic, then low-burn polls past the cooldown
        assert _post(srv.port, {"source": sources[0]})[0] == 200
        for _ in range(BROWNOUT_KW["down_consecutive"]):
            clock.t += BROWNOUT_KW["cooldown_s"]
            srv.brownout.poll_once()
        assert json.loads(_get(srv.port, "/healthz")[1])[
            "brownout_level"] == 0
        assert pc.check_gates(shadow) is None
    finally:
        srv.shutdown()


def test_admission_config_equals_jax():
    cfgs = [AdmissionConfig(**ADMISSION_KW), JAdmissionConfig(**ADMISSION_KW)]
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    for bad in (dict(batch_rate=0), dict(max_level=0), dict(burn_low=3.0),
                dict(depth_shed_factor=-1.0), dict(cooldown_s=0)):
        msgs = []
        for cls in (AdmissionConfig, JAdmissionConfig):
            with pytest.raises(ValueError) as e:
                cls(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
