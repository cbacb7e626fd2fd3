"""The port's multi-cell federation (``deepdfa_tpu_torch/serve/
federation.py``) against the JAX package's, on the CPU.

The JAX module imports no JAX, so both ``FederationRouter`` classes run
here:

- ``plan_route`` is equal for 1,000 keys over the same cells and states
  (ready, down, saturated by each of the three signals, burned);
- ``handle_score`` through both federation routers over the same real
  port cells (each a ``ScoreServer`` on a CPU stub engine behind its
  ``FleetRouter``, probes manual): equal codes, bodies and routing
  headers, key for key, through sticky serving, spillover off a cell
  forced into brownout, ``federation.spillover_drop``,
  ``federation.probe_partition``, a cell drain and undrain, a fleet-wide
  shed (429 with the largest Retry-After), a cell's death and
  ``federation.cell_kill``; never a 5xx. Each package runs the scenario
  on fresh cells bound to the same ports (the ring hashes the cells'
  names), so both see the same state. A cell's ``/slo`` burn is wall
  clock: both routers read it as 0.0 in that test, so a route depends
  only on state;
- ``federation_specs`` is equal in both packages;
- the slice: two port cells with admission on, behind the port's
  ``FederationRouter``, score the demo sources within ``ATOL`` (1e-5) of
  the JAX server on the same parameters (``bridge.flax_to_torch``).

Every wait is a manual probe or a bounded socket call; no sleeps.
"""

import dataclasses
import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.config import FederationConfig as JFederationConfig  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import ServeConfig as JServeConfig  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.obs import federation_specs as jfederation_specs  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.serve import ScoreServer as JServer  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.serve import federation as jfed  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, AdmissionConfig,  # noqa: E402
                                      FederationConfig, GGNNConfig,
                                      ServeConfig)
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.obs import federation_specs  # noqa: E402
from deepdfa_tpu_torch.pipeline import source_key  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine, serve_buckets  # noqa: E402
from deepdfa_tpu_torch.serve import federation as tfed  # noqa: E402
from deepdfa_tpu_torch.serve.router import FleetRouter  # noqa: E402
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402

SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
INPUT_DIM = JFeatureConfig().input_dim
ATOL = 1e-5  # the serve tests' tolerance on a live engine's scores
PKGS = {"jax": (jfed, JFederationConfig, jfaults),
        "torch": (tfed, FederationConfig, faults)}
HOUR = 3600.0  # a probe or poll interval no test waits out
# the cells' admission: budgets no scenario request exhausts, the
# brownout thread idle (polls are the test's), one cell's level forced
CELL_ADMISSION = dict(enabled=True, interactive_rate=1000.0,
                      interactive_burst=1000.0, batch_rate=1000.0,
                      batch_burst=1000.0, poll_interval_s=HOUR)
ROUTE_HEADERS = ("Retry-After", "X-DeepDFA-Cell", "X-DeepDFA-Spillover")


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


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


# ------------------------------------------------------------ plan_route


def _offline(pkg, n, **cfg_kw):
    """A federation over ``n`` named cells, none probed (no socket but its
    own listener)."""
    mod, cfg_cls, _ = PKGS[pkg]
    fed = mod.FederationRouter(
        cells=[f"10.0.0.{i + 1}:89{i:02d}" for i in range(n)],
        cfg=cfg_cls(probe_interval_s=HOUR, **cfg_kw))
    for c in fed.cells.values():
        fed._mark(c, "ready", {})
    return fed


def _state(fed, rng):
    """Seeded states, health and burns over the cells of ``fed``."""
    for c in fed.cells.values():
        roll = rng.random()
        if roll < 0.15:
            fed._mark(c, "down", {"error": "x"})
            continue
        health = {}
        if rng.random() < 0.3:
            health["brownout_level"] = int(rng.integers(0, 4))
        if rng.random() < 0.3:
            health["frontend_queue_wait_p99_ms"] = float(
                rng.choice([10.0, 4999.0, 5000.0, 9000.0]))
        fed._mark(c, "ready", health)
        c.burn = (None if rng.random() < 0.3
                  else float(rng.choice([0.0, 0.5, 1.99, 2.0, 3.5])))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (3, 2), (5, 3), (8, 4)])
def test_plan_route_equals_jax(n, seed):
    feds = {pkg: _offline(pkg, n) for pkg in PKGS}
    try:
        keys = [source_key(f"int f{i}(int x) {{ return x + {i}; }}")
                for i in range(1000)]
        for round_ in range(3):
            for pkg, fed in feds.items():
                _state(fed, np.random.default_rng(seed * 10 + round_))
            plans = {pkg: [fed.plan_route(k) for k in keys]
                     for pkg, fed in feds.items()}
            assert plans["torch"] == plans["jax"]
            sat = {pkg: [fed.saturated(c) for c in fed.cells.values()]
                   for pkg, fed in feds.items()}
            assert sat["torch"] == sat["jax"]
    finally:
        for fed in feds.values():
            fed.httpd.server_close()


def test_plan_route_is_sticky_and_demotes_a_saturated_owner():
    fed = _offline("torch", 3)
    try:
        keys = [source_key(f"int g{i}(void) {{ return {i}; }}")
                for i in range(64)]
        owners = {k: fed.plan_route(k)[0] for k in keys}
        assert len(set(owners.values())) == 3
        assert all(fed.plan_route(k)[0] == owners[k] for k in keys)
        key = keys[0]
        owner = fed.cells[owners[key]]
        owner.health = {"brownout_level": 1}
        plan = fed.plan_route(key)
        assert plan[0] != owner.name and plan[-1] == owner.name
    finally:
        fed.httpd.server_close()


def test_federation_specs_equal_jax():
    for kw in ({}, dict(availability=0.999, p99_ms=250.0)):
        assert [dataclasses.asdict(s) for s in federation_specs(**kw)] == \
            [dataclasses.asdict(s) for s in jfederation_specs(**kw)]


def test_federation_config_equals_jax():
    kw = dict(enabled=True, cells=["a:1", "b:2"], vnodes=8,
              spill_brownout_level=2, retry_after_floor_s=3)
    assert dataclasses.asdict(FederationConfig(**kw)) == \
        dataclasses.asdict(JFederationConfig(**kw))
    for bad in (dict(cells=["nocolon"]), dict(vnodes=0),
                dict(spill_brownout_level=4), dict(retry_after_floor_s=0)):
        msgs = []
        for cls in (FederationConfig, JFederationConfig):
            with pytest.raises(ValueError) as e:
                cls(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------ over real cells


def _stub_engine(tv):
    return ScoringEngine(
        lambda batch: np.full(batch.max_graphs, 0.25, np.float32),
        serve_buckets(4), feat_keys=tuple(tv))


class _Cells:
    """Port cells: a ``ScoreServer`` behind its own ``FleetRouter`` each,
    probes manual, admission on one clock that moves only when the test
    moves it; cell ``i`` refills its interactive budget at ``rates[i]``
    a second. ``ports`` rebinds the listeners of an earlier set (the ring
    hashes the cells' names)."""

    def __init__(self, tv, n, ports=None, engine=None, rates=None):
        self.cells = []
        self.clock = clock = _Clock()
        for i in range(n):
            srv_port, router_port = ports[i] if ports else (0, 0)
            adm = dict(CELL_ADMISSION)
            if rates:
                adm["interactive_rate"] = rates[i]
            srv = ScoreServer(engine() if engine else _stub_engine(tv), tv,
                              ServeConfig(port=srv_port, max_wait_ms=2.0,
                                          admission=AdmissionConfig(**adm)))
            srv.admission._clock = clock
            srv.admission._t0 = clock()
            srv.warmup()
            srv.start()
            router = FleetRouter([f"127.0.0.1:{srv.port}"], port=router_port,
                                 probe_interval_s=HOUR)
            router.probe_once()
            router.start(probe=False)
            self.cells.append([srv, router, True])

    @property
    def ports(self):
        return [(srv.port, router.port) for srv, router, _ in self.cells]

    def name(self, i):
        return f"127.0.0.1:{self.cells[i][1].port}"

    def probe(self):
        for srv, router, alive in self.cells:
            if alive:
                router.probe_once()

    def kill(self, i):
        """The cell's router stops answering (its replica too)."""
        srv, router, alive = self.cells[i]
        if alive:
            router.shutdown()
            srv.shutdown()
            self.cells[i][2] = False

    def close(self):
        for i in range(len(self.cells)):
            self.kill(i)


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = payload if isinstance(payload, bytes) else json.dumps(payload)
        conn.request("POST", "/score", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, json.loads(resp.read() or b"{}"),
                {h: resp.getheader(h) for h in ROUTE_HEADERS})
    finally:
        conn.close()


def _scenario(pkg, tv, sources, ports=None):
    """The federation scenario of one package over fresh port cells;
    returns what it saw and the cells' ports."""
    mod, cfg_cls, registry = PKGS[pkg]
    # a drained bucket asks 2, 4 and 1 s to refill one token
    cells = _Cells(tv, 3, ports, rates=(0.5, 0.25, 1000.0))
    names = [cells.name(i) for i in range(3)]
    fed = mod.FederationRouter(cells=names, cfg=cfg_cls(
        probe_interval_s=HOUR, drain_deadline_s=5.0))
    fed._probe_burn = lambda c: 0.0  # the cells' wall-clock burn, as 0.0
    fed.kill_hook = lambda name: cells.kill(names.index(name))
    seen = []

    def score(tag, payload):
        status, body, headers = _post(fed.port, payload)
        seen.append((tag, status, body, headers))
        assert status < 500, (tag, status, body)
        return status, body, headers

    def probe(tag):
        cells.probe()
        seen.append((tag, fed.probe_once()))

    def variants(tag, k=8, owner=None):
        """``k`` fresh sources, each owned by cell ``owner`` if named."""
        out, i = [], 0
        while len(out) < k:
            src = sources[i % len(sources)] + f"\n// {tag} {i}\n"
            i += 1
            if owner is None or fed.ring.route(source_key(src)) == owner:
                out.append((f"{tag}{len(out)}", {"source": src}))
        return out

    try:
        fed.start(probe=False)
        probe("first probe")
        for tag, payload in variants("sticky") + variants("sticky"):
            score(tag, payload)  # the second lap: cache hits, same cells
        score("bad", b"{nope")
        score("empty", {"source": ""})
        # cell 0 browns out: its keys spill to the least-burned sibling
        with faults.installed("admission.brownout_force@1"):
            cells.cells[0][0].brownout.poll_once()
        probe("brownout probe")
        for tag, payload in variants("spill") + variants(
                "spill_owned", 4, owner=names[0]):
            score(tag, payload)
        with registry.installed("federation.spillover_drop@1"):
            for tag, payload in variants("drop", 4, owner=names[0]):
                score(tag, payload)
        with registry.installed("federation.probe_partition@2"):
            probe("partitioned probe")
        probe("clean probe")
        # a drain is flag-only and ring-exit first; undrain readmits
        ok, drained = fed.drain_cell(names[1])
        seen.append(("drain", ok, drained))
        for tag, payload in variants("drained", 4):
            score(tag, payload)
        ok, undrained = fed.undrain_cell(names[1])
        seen.append(("undrain", ok, undrained))
        probe("undrain probe")
        # every cell sheds: a fleet-wide 429 with the largest Retry-After
        with faults.installed("admission.bucket_exhausted"):
            for tag, payload in variants("fleetwide", 2):
                score(tag, payload)
        cells.clock.t += 100.0  # the drained buckets refill
        # a cell dies at the socket; then federation.cell_kill takes one
        dead = variants("dead", 4, owner=names[2])
        cells.kill(2)
        for tag, payload in dead:
            score(tag, payload)
        with registry.installed("federation.cell_kill@1"):
            probe("cell_kill probe")
        for tag, payload in variants("survivor", 4):
            score(tag, payload)
        cells.kill(0)
        cells.kill(1)
        score("no cell", {"source": sources[0] + "\n// none\n"})
        seen.append(("healthz", fed.healthz()))
        seen.append(("admin", fed.admin_cells()))
        snap = fed.metrics.snapshot()
        seen.append(("metrics", {k: v for k, v in snap.items()
                                 if not k.startswith("latency")}))
    finally:
        fed.shutdown()
        ports = cells.ports
        cells.close()
    return seen, ports


def test_handle_score_over_real_cells_equals_jax(demo):
    _, tv, sources = demo
    want, ports = _scenario("jax", tv, sources)
    got, _ = _scenario("torch", tv, sources, ports)
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    by_tag = {g[0]: g for g in got}
    metrics = by_tag["metrics"][1]
    assert metrics["spillover_total"] > 0
    assert metrics["spillover_errors_total"] == 1
    assert metrics["fleetwide_shed_total"] == 2
    assert metrics["fleetwide_5xx_total"] == 0
    assert metrics["no_cell_total"] == 1
    assert by_tag["fleetwide0"][1] == 429 and \
        by_tag["fleetwide0"][3]["Retry-After"] == "4" == str(
            by_tag["fleetwide0"][2]["retry_after_s"])
    assert "down" in by_tag["partitioned probe"][1].values()
    assert set(by_tag["clean probe"][1].values()) == {"ready"}
    assert by_tag["drain"][1] and by_tag["drain"][2]["state"] == "draining"
    assert list(by_tag["cell_kill probe"][1].values()).count("down") == 2
    answers = [g for g in got if len(g) == 4]  # the scored requests
    assert all(g[1] in (200, 429) for g in answers
               if g[0] not in ("bad", "empty"))


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def live(demo):
    jv, _, sources = demo
    jmodel = JGGNN(cfg=JCfg(**SMALL, layout="segment"), input_dim=INPUT_DIM)
    g = jencode(sources[0], jv)[0].graph
    example = jax.tree.map(jnp.asarray, jbatch_np([g], 2, 64, 256))
    params = jmodel.init(jax.random.key(3), example)["params"]
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 GGNNConfig(**SMALL, layout="fused"),
                                 INPUT_DIM)
    return jmodel, params, state


def test_two_cells_behind_the_federation_score_like_the_jax_server(demo,
                                                                   live):
    jv, tv, sources = demo
    jmodel, params, state = live

    def engine():
        return ScoringEngine.from_model(
            make_model(GGNNConfig(**SMALL, layout="fused"), INPUT_DIM,
                       device="cpu"),
            state, "graph", feat_keys=KEYS, max_batch=4, device="cpu")

    jsrv = JServer(JEngine.from_model(jmodel, params, "graph",
                                      feat_keys=KEYS, max_batch=4),
                   jv, JServeConfig(port=0, max_wait_ms=2.0)).start()
    cells = _Cells(tv, 2, engine=engine)
    fed = tfed.FederationRouter(
        cells=[cells.name(0), cells.name(1)],
        cfg=FederationConfig(probe_interval_s=HOUR))
    try:
        fed.probe_once()
        fed.start(probe=False)
        # the ring hashes the cells' names, which hold the ports the system
        # hands out, so the demo sources alone may all stick to one cell:
        # small generated functions follow until each cell owns one
        pool = sources + ["\n".join(sources[:3])]
        extra = 0
        while len({fed.ring.route(source_key(s)) for s in pool}) < 2:
            pool.append(f"int extra_{extra}(int a) {{ return a + {extra}; }}")
            extra += 1
        served = set()
        for src in pool:
            got = _post(fed.port, {"source": src})
            want = _post(jsrv.port, {"source": src})
            assert got[0] == want[0] == 200
            assert got[2]["X-DeepDFA-Cell"] == fed.ring.route(source_key(src))
            served.add(got[2]["X-DeepDFA-Cell"])
            rows = zip(got[1]["results"], want[1]["results"], strict=True)
            for a, b in rows:
                assert a["function"] == b["function"]
                assert a["vulnerable_probability"] == pytest.approx(
                    b["vulnerable_probability"], abs=ATOL)
        assert served == {cells.name(0), cells.name(1)}
    finally:
        fed.shutdown()
        cells.close()
        jsrv.shutdown()


def test_the_entry_point_refuses_no_cell():
    with pytest.raises(SystemExit):
        tfed.main([])
