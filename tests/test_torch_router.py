"""The port's fleet router (``deepdfa_tpu_torch/serve/router.py``) against
the JAX package's, on the CPU, over stub backends (no engine) and over
real port ``ScoreServer`` replicas with stub score functions.

- ``HashRing.route``: node for node the JAX ring's on 10,000 keys, as
  nodes join and leave (both hash with sha256 the same way);
- both routers in front of the same stub fleet send every source to the
  same backend (the ``X-DeepDFA-Backend`` header) and answer ``/healthz``
  with the same body;
- the fleet cases of ``tests/test_serve.py``: stable sharding, the
  readiness gate, drain-aware rebalancing, failover past a dead backend,
  503 with no ready backend, ``/metrics``, and the sharded cache on real
  servers; plus the membership surface (``/admin/backends``,
  ``/admin/drain``, :class:`AdminRouterClient`), ``/slo`` and the entry
  point ``python -m deepdfa_tpu_torch.serve.router``.

Every wait is on an event, a future or a poll of state, never a sleep.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.serve.router import FleetRouter as JFleetRouter  # noqa: E402
from deepdfa_tpu.serve.router import HashRing as JHashRing  # noqa: E402

from deepdfa_tpu_torch.config import ServeConfig  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine, serve_buckets  # noqa: E402
from deepdfa_tpu_torch.serve.autoscaler import AdminRouterClient  # noqa: E402
from deepdfa_tpu_torch.serve.router import (FleetRouter,  # noqa: E402
                                            HashRing, RouterMetrics)
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _req(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _route_post(port, source):
    status, data, headers = _req(port, "POST", "/score",
                                 json.dumps({"source": source}))
    return status, json.loads(data), headers


class _FakeBackend:
    """A /healthz + /score stub standing in for a ScoreServer replica:
    records every source it scores, health body mutable per test."""

    def __init__(self, name):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.name = name
        self.scored = []
        self.health = {"status": "ok", "draining": False, "warm": True,
                       "replica_id": name}
        backend = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                h = backend.health
                self._send(503 if h.get("draining") else 200, h)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(n) or b"{}")
                backend.scored.append(payload.get("source"))
                self._send(200, {"results": [], "backend": backend.name})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def addr(self):
        return f"127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def fake_fleet():
    backends = [_FakeBackend(f"r{i}") for i in range(3)]
    router = FleetRouter([b.addr for b in backends], port=0,
                         probe_interval_s=60.0)
    router.probe_once()
    router.start(probe=False)
    try:
        yield router, backends
    finally:
        router.shutdown()
        for b in backends:
            b.stop()


# ---------------------------------------------------------------- the ring


def test_hash_ring_routes_node_for_node_as_jax():
    mine, ref = HashRing(), JHashRing()
    keys = [f"key-{i}" for i in range(10_000)]
    names = [f"10.0.0.{i}:{8000 + i}" for i in range(6)]

    def same():
        return all(mine.route(k) == ref.route(k) for k in keys)

    assert mine.route("k") is None and ref.route("k") is None
    for name in names[:4]:
        mine.add(name)
        ref.add(name)
    assert same() and mine.nodes == ref.nodes
    mine.remove(names[1])
    ref.remove(names[1])
    for name in names[4:]:
        mine.add(name)
        ref.add(name)
    assert same() and len(mine) == len(ref) == 5
    excl = frozenset(names[2:4])
    assert all(mine.route(k, exclude=excl) == ref.route(k, exclude=excl)
               for k in keys[:2000])
    # consistent hashing: a join moves ~1/N of the keyspace, no more
    before = {k: mine.route(k) for k in keys}
    mine.add("10.0.0.9:9999")
    moved = sum(before[k] != mine.route(k) for k in keys)
    assert 0 < moved < len(keys) // 3


def test_both_routers_send_each_source_to_the_same_backend():
    backends = [_FakeBackend(f"r{i}") for i in range(3)]
    addrs = [b.addr for b in backends]
    routers = [FleetRouter(addrs, port=0, probe_interval_s=60.0),
               JFleetRouter(addrs, port=0, probe_interval_s=60.0)]
    try:
        for r in routers:
            r.probe_once()
            r.start(probe=False)
        for i in range(40):
            src = f"int f{i}(int x) {{ return x + {i}; }}"
            (s1, b1, h1), (s2, b2, h2) = (_route_post(r.port, src)
                                          for r in routers)
            assert s1 == s2 == 200 and b1 == b2
            assert h1["X-DeepDFA-Backend"] == h2["X-DeepDFA-Backend"]
        (c1, d1, _), (c2, d2, _) = (_req(r.port, "GET", "/healthz")
                                    for r in routers)
        assert c1 == c2 == 200 and json.loads(d1) == json.loads(d2)
        (c1, d1, _), (c2, d2, _) = (_req(r.port, "GET", "/admin/backends")
                                    for r in routers)
        assert json.loads(d1) == json.loads(d2)
    finally:
        for r in routers:
            r.shutdown()
        for b in backends:
            b.stop()


# ------------------------------------------------------ the fleet (stubs)


def test_router_shards_keys_stably_across_backends(fake_fleet):
    router, backends = fake_fleet
    assert all(b.state == "ready" for b in router.backends.values())
    sources = [f"int f{i}(int x) {{ return x + {i}; }}" for i in range(24)]
    for s in sources:
        assert _route_post(router.port, s)[0] == 200
    counts = {b.name: len(b.scored) for b in backends}
    assert sum(counts.values()) == 24
    assert all(c > 0 for c in counts.values())
    for s in sources:  # replay: every key lands on the same shard
        assert _route_post(router.port, s)[0] == 200
    for b in backends:
        assert b.scored[: len(b.scored) // 2] == b.scored[len(b.scored) // 2:]


def test_router_readiness_gates_cold_replicas(fake_fleet):
    router, backends = fake_fleet
    backends[0].health["warm"] = False
    router.probe_once()
    assert router.backends[backends[0].addr].state == "pending"
    assert backends[0].addr not in router.ring.nodes
    for i in range(12):
        assert _route_post(router.port, f"int g{i}() {{ return {i}; }}")[0] \
            == 200
    assert backends[0].scored == []  # took no traffic while cold
    backends[0].health["warm"] = True
    router.probe_once()
    assert router.backends[backends[0].addr].state == "ready"


def test_router_drain_rebalances_keyspace(fake_fleet):
    router, backends = fake_fleet
    sources = [f"int h{i}(int x) {{ return x * {i}; }}" for i in range(18)]
    for s in sources:
        _route_post(router.port, s)
    owner_before = {s: next(b.name for b in backends if s in b.scored)
                    for s in sources}
    drained = backends[1]
    drained.health.update(status="draining", draining=True)
    router.probe_once()
    assert router.backends[drained.addr].state == "draining"
    assert drained.addr not in router.ring.nodes
    n_before = len(drained.scored)
    for s in sources:
        assert _route_post(router.port, s)[0] == 200
    assert len(drained.scored) == n_before  # no new traffic
    survivors = [b for b in backends if b is not drained]
    for s in sources:
        if owner_before[s] == drained.name:
            assert any(s in b.scored for b in survivors), s
        else:
            b = next(x for x in survivors if x.name == owner_before[s])
            assert b.scored.count(s) == 2, s


def test_router_fails_over_dead_backend_and_healthz_reports(fake_fleet):
    router, backends = fake_fleet
    dead = backends[2]
    dead.stop()
    for i in range(12):
        status, body, _ = _route_post(
            router.port, f"int k{i}(int x) {{ return x - {i}; }}")
        assert status == 200, body
    assert router.backends[dead.addr].state == "down"
    status, data, _ = _req(router.port, "GET", "/healthz")
    health = json.loads(data)
    assert status == 200
    assert dead.addr not in health["ready_backends"]
    assert health["backends"][dead.addr]["state"] == "down"
    assert router.metrics.snapshot()["retries_total"] >= 1


def test_router_with_no_ready_backend_is_503(fake_fleet):
    router, backends = fake_fleet
    for b in backends:
        b.health.update(status="draining", draining=True)
    router.probe_once()
    assert _req(router.port, "GET", "/healthz")[0] == 503
    status, body, _ = _route_post(router.port, "int z() { return 0; }")
    assert status == 503 and "no ready backend" in body["error"]
    assert router.metrics.snapshot()["no_backend_total"] == 1


def test_router_metrics_and_slo_render_as_jax():
    mine, ref = RouterMetrics(), __import__(
        "deepdfa_tpu.serve.router", fromlist=["RouterMetrics"]).RouterMetrics()
    for m in (mine, ref):
        m.inc("requests_total", 5)
        m.inc("errors_total")
        m.observe_forward("a:1")
        for ms in (1.0, 2.0, 40.0):
            m.latency.observe(ms)
    assert mine.snapshot() == ref.snapshot()
    assert mine.render() == ref.render()


def test_router_metrics_slo_and_bad_bodies(fake_fleet):
    router, _ = fake_fleet
    _route_post(router.port, "int m() { return 1; }")
    status, data, _ = _req(router.port, "GET", "/metrics")
    text = data.decode()
    assert status == 200
    for field in ("deepdfa_router_requests_total",
                  "deepdfa_router_forwarded_total",
                  "deepdfa_router_retries_total",
                  "deepdfa_router_no_backend_total"):
        assert field in text, field
    status, data, _ = _req(router.port, "GET", "/slo")
    assert status == 200 and "availability" in data.decode()
    assert _req(router.port, "POST", "/score", b"{not json")[0] == 400
    assert _req(router.port, "POST", "/score", b'{"source": ""}')[0] == 400
    assert _req(router.port, "GET", "/nope")[0] == 404


def test_membership_surface_and_admin_client(fake_fleet):
    """``/admin/backends`` add is readiness-gated, remove only drops ring
    membership; ``/admin/drain`` is flag-only and reversible; the HTTP
    client is duck-compatible with the in-process router."""
    router, backends = fake_fleet
    extra = _FakeBackend("r9")
    try:
        client = AdminRouterClient("127.0.0.1", router.port)
        extra.health["warm"] = False
        out = client.add_backend(extra.addr)
        assert out == {"backend": extra.addr, "state": "pending"}
        assert extra.addr not in router.ring.nodes
        extra.health["warm"] = True
        router.probe_once()  # the router's own probe admits it
        assert client.probe_once()[extra.addr] == "ready"
        assert extra.addr in router.ring.nodes
        assert client.remove_backend(extra.addr) is True
        assert client.remove_backend(extra.addr) is False
        assert extra.addr not in router.ring.nodes
        assert _req(router.port, "POST", "/admin/backends",
                    b'{"action": "x"}')[0] == 400
        code, data, _ = _req(router.port, "POST", "/admin/drain",
                             b'{"action": "drain"}')
        assert code == 200 and json.loads(data)["draining"] is True
        assert _req(router.port, "GET", "/healthz")[0] == 503
        assert _route_post(router.port, "int d() { return 2; }")[0] == 503
        _req(router.port, "POST", "/admin/drain", b'{"action": "undrain"}')
        assert _route_post(router.port, "int d() { return 2; }")[0] == 200
    finally:
        extra.stop()


# ------------------------------------------------- real port replicas


def _stub_engine(feat_keys, prob=0.25):
    def score_fn(batch):
        return np.full(batch.max_graphs, prob, np.float32)

    return ScoringEngine(score_fn, serve_buckets(4), feat_keys=feat_keys)


@pytest.fixture(scope="module")
def demo():
    from deepdfa_tpu_torch.config import FeatureConfig
    from deepdfa_tpu_torch.cpg.features import add_dependence_edges
    from deepdfa_tpu_torch.cpg.frontend import parse_source
    from deepdfa_tpu_torch.data.codegen import demo_corpus
    from deepdfa_tpu_torch.data.materialize import CorpusBuilder

    rows = demo_corpus(6, seed=0)
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, vocabs = CorpusBuilder(FeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    return vocabs, [r["before"] for r in rows]


def _sources_on_every_node(ring, pool, per_node: int) -> list[str]:
    """The first ``per_node`` sources of ``pool`` that ``ring`` routes to
    each of its nodes. The ring hashes the replicas' names, which hold
    the ports the system hands out, so a fixed handful of sources can all
    land on one replica (6 sources over 2 replicas: 4.5 % of port pairs);
    picking them by the ring's own assignment keeps both shards busy."""
    from deepdfa_tpu_torch.pipeline import source_key

    picked = {node: [] for node in ring.nodes}
    for src in pool:
        node = ring.route(source_key(src))
        if len(picked[node]) < per_node:
            picked[node].append(src)
        if all(len(v) == per_node for v in picked.values()):
            return [s for v in picked.values() for s in v]
    raise AssertionError(f"the pool left a node short: {picked}")


def _source_pool(sources):
    """The demo sources, then as many small distinct functions as a pick
    needs."""
    yield from sources
    i = 0
    while True:
        yield f"int extra_{i}(int a) {{ return a + {i}; }}"
        i += 1


def test_router_sharded_cache_hits_real_servers(demo):
    """Replayed sources route back to the replica that cached them: each
    replica's hit counter equals the number of sources the ring assigns
    it, every replica takes some, and no shard duplicates another's
    entries."""
    from deepdfa_tpu_torch.pipeline import source_key

    vocabs, demo_sources = demo
    servers = [ScoreServer(_stub_engine(tuple(vocabs)), vocabs,
                           ServeConfig(port=0, max_wait_ms=2.0),
                           replica_id=f"r{i}").start()
               for i in range(2)]
    for s in servers:
        s.engine.warmup()  # readiness: the probe gates on warm
    router = FleetRouter([f"127.0.0.1:{s.port}" for s in servers], port=0,
                         probe_interval_s=60.0)
    router.probe_once()
    router.start(probe=False)
    try:
        names = [f"127.0.0.1:{s.port}" for s in servers]
        assert sorted(router.ring.nodes) == sorted(names)
        sources = _sources_on_every_node(router.ring,
                                         _source_pool(demo_sources), 3)
        owner = [router.ring.route(source_key(src)) for src in sources]
        for src in sources:
            status, body, _ = _route_post(router.port, src)
            assert status == 200 and body["cached"] is False
        for src in sources:
            status, body, _ = _route_post(router.port, src)
            assert status == 200 and body["cached"] is True, body
        hits = [s.cache.stats()["hits"] for s in servers]
        entries = [s.cache.stats()["entries"] for s in servers]
        assert hits == [owner.count(n) for n in names] == [3, 3]
        assert entries == hits
    finally:
        router.shutdown()
        for s in servers:
            s.shutdown()


def test_the_router_entry_point_routes_and_drains(fake_fleet):
    """``python -m deepdfa_tpu_torch.serve.router``: one ``routing`` line
    with the bound port, requests through it, SIGTERM → ``drained``."""
    _, backends = fake_fleet
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "deepdfa_tpu_torch.serve.router",
           "--port", "0", "--probe-interval", "60"]
    for b in backends:
        cmd += ["--backend", b.addr]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env,
                            cwd=str(REPO))
    try:
        line = json.loads(proc.stdout.readline())
        assert line["status"] == "routing"
        assert set(line["backends"].values()) == {"ready"}
        for i in range(6):
            assert _route_post(line["port"], f"int e{i}() {{ return 0; }}"
                               )[0] == 200
        proc.send_signal(signal.SIGTERM)
        done = json.loads(proc.stdout.readline())
        assert done["status"] == "drained" and done["requests_total"] == 6
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
