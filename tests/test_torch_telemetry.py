"""The port's training telemetry (deepdfa_tpu_torch/obs/telemetry.py, the
trainer SLO specs, ``load_trace_records``) against the JAX package's on the
same feed, its scrape endpoint over HTTP on port 0, and its place in
``Trainer.train_epoch`` and ``fit`` on the CPU.

Tolerances: the exposition bodies, ``/healthz`` (but for the uptime) and
``/slo`` on the same feed and clock are compared exactly; a telemetered
``fit`` must equal an untelemetered one bit for bit; TensorBoard scalars
are float32 copies of the journal's float64 values (1e-6 relative).
"""

import http.client
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.obs import slo as jslo  # noqa: E402
from deepdfa_tpu.obs import telemetry as jtel  # noqa: E402
from deepdfa_tpu.obs import tracing as jtracing  # noqa: E402

from deepdfa_tpu_torch.config import load_config  # noqa: E402
from deepdfa_tpu_torch.data.graphs import BucketSpec, GraphBatcher  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.obs import slo, telemetry, tracing  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.fit import fit  # noqa: E402
from deepdfa_tpu_torch.train.loop import Trainer  # noqa: E402

FEED = [  # (wait_s, dispatch_s, shape_key, flops)
    (0.001, 0.020, ("a",), None),
    (0.002, 0.030, ("b",), 1e9),
    (0.0, 0.025, ("a",), 2e9),
    (0.004, 0.010, ("c",), None),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits: they run as fast
    as on every core, and six test workers with a thread per core each
    oversubscribe the host ten times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_storage(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("DEEPDFA_STORAGE",
                       str(tmp_path_factory.mktemp("storage")))


def _fed(mod, trmod, slomod, clock):
    spec = slomod.train_specs(step_ms=20.0, mfu_floor=0.5)
    tel = mod.TrainTelemetry(
        tracer=trmod.Tracer(proc="train"), roofline_flops_per_s=1e12,
        slo=slomod.SLOEngine(spec, clock=clock))
    tel.observe_epoch(3)
    for wait, disp, key, flops in FEED:
        tel.observe_step(wait, disp, shape_key=key, flops=flops)
    return tel


def test_telemetry_equals_jax_on_the_same_feed():
    clock = lambda: 1000.0  # noqa: E731
    mine = _fed(telemetry, tracing, slo, clock)
    ref = _fed(jtel, jtracing, jslo, clock)
    assert mine.render() == ref.render()
    strip = lambda d: {k: v for k, v in d.items() if k != "uptime_s"}  # noqa: E731
    assert strip(mine.healthz()) == strip(ref.healthz())
    assert mine.render_slo() == ref.render_slo()
    assert "deepdfa_train_compiles_total 3" in mine.render()
    assert mine.epoch_stats() == ref.epoch_stats()
    assert mine.epoch_stats() == ref.epoch_stats() == {
        "steps": 0, "wall_s": 0.0, "data_wait_s": 0.0, "dispatch_s": 0.0,
        "compiles": 0}
    # no engine attached: /slo still renders the counter families
    assert telemetry.TrainTelemetry().render_slo() == \
        jtel.TrainTelemetry().render_slo()


@pytest.mark.parametrize("kw", [{}, {"step_ms": 5.0}, {"mfu_floor": 0.3},
                                {"step_ms": 1.0, "mfu_floor": 0.9}])
def test_train_specs_equal_jax(kw):
    assert slo.train_specs(**kw) == tuple(
        slo.SLOSpec(**{f: getattr(s, f) for f in
                       ("name", "kind", "target", "bad", "total", "value")})
        for s in jslo.train_specs(**kw))


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_the_scrape_endpoint_on_port_zero():
    tel = _fed(telemetry, tracing, slo, lambda: 1000.0)
    server = telemetry.TelemetryServer(tel, port=0).start()
    try:
        assert server.port > 0
        status, ctype, body = _get(server.port, "/metrics")
        assert (status, ctype) == (200, "text/plain; version=0.0.4")
        assert body.decode() == tel.render()
        families = {line.split()[2] for line in body.decode().splitlines()
                    if line.startswith("# TYPE")}
        assert families == {
            "deepdfa_train_steps_total", "deepdfa_train_compiles_total",
            "deepdfa_train_data_wait_seconds_total",
            "deepdfa_train_dispatch_seconds_total", "deepdfa_train_epoch",
            "deepdfa_train_last_step_seconds", "deepdfa_train_mfu",
            "deepdfa_train_trace_spans_dropped_total"}
        status, ctype, body = _get(server.port, "/healthz")
        health = json.loads(body)
        assert (status, ctype) == (200, "application/json")
        assert health["ok"] and health["role"] == "trainer"
        assert health["steps"] == len(FEED) and health["epoch"] == 3
        status, _, body = _get(server.port, "/slo")
        assert status == 200 and b'slo="step_time"' in body
        assert b'slo="mfu_floor"' in body
        assert _get(server.port, "/nope")[0] == 404
    finally:
        server.stop()


def test_load_trace_records_equals_jax(tmp_path):
    tracer = tracing.Tracer(proc="train", slow_ms=0.0, exemplar_dir=tmp_path)
    with tracer.span("train.epoch", root=True) as sp:
        tracer.record("step.dispatch", 1.0, 1.5, parent=sp.ctx, step=0)
    (tmp_path / "trace-junk.json").write_text("{not json")
    (tmp_path / "trace-other.json").write_text('{"event": "other"}')
    got = tracing.load_trace_records(tmp_path)
    assert got == jtracing.load_trace_records(tmp_path) and len(got) == 1
    one = next(p for p in tmp_path.glob("trace-*.json")
               if p.name not in ("trace-junk.json", "trace-other.json"))
    assert tracing.load_trace_records(one) == got


def test_train_epoch_reports_every_step_and_first_shapes():
    cfg = load_config(overrides={"model.hidden_dim": 8, "model.n_steps": 2,
                                 "model.num_output_layers": 2,
                                 "model.layout": "fused",
                                 "data.feature.limit_all": 50})
    graphs = random_dataset(40, seed=2, input_dim=cfg.input_dim, vul_rate=0.4)
    batcher = GraphBatcher([BucketSpec(9, 512, 1024), BucketSpec(17, 1024,
                                                                 2048)])
    batches = list(batcher.batches(graphs))
    shapes = {(b.max_graphs, b.max_nodes) for b in batches}
    model = make_model(cfg.model, cfg.input_dim, device="cpu")
    trainer = Trainer(model, cfg, pos_weight=3.0)
    state = trainer.init_state()
    tel = telemetry.TrainTelemetry(tracer=tracing.Tracer(proc="train"))
    for epoch, compiles in ((0, len(shapes)), (1, 0)):
        tel.observe_epoch(epoch)
        state, _, _ = trainer.train_epoch(state, batches, telemetry=tel)
        stats = tel.epoch_stats()
        assert stats["steps"] == len(batches) == len(trainer.step_ms)
        assert stats["compiles"] == compiles
        assert stats["dispatch_s"] > 0 and 0 <= stats["data_wait_frac"] < 1
    names = [s.name for s in tel.tracer.spans()]
    assert names.count("train.epoch") == 2
    assert names.count("step.dispatch") == names.count("data.wait") == \
        2 * len(batches)
    assert names.count("device.sync") == 2


_TINY = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.sample": True, "data.undersample": None,
    "data.feature.limit_all": 50, "data.batch.batch_graphs": 32,
    "data.batch.max_nodes": 160, "data.batch.max_edges": 320,
    "optim.max_epochs": 2}


def test_a_telemetered_fit_is_bitwise_a_bare_one(tmp_path, caplog):
    with caplog.at_level("INFO", logger="deepdfa_tpu_torch"):
        on = fit(load_config(overrides=_TINY | {"serve.obs.train_port": 0}),
                 tmp_path / "on", device="cpu")
    off = fit(load_config(overrides=_TINY | {"serve.obs.trace": False}),
              tmp_path / "off", device="cpu")
    assert on == off
    a = CheckpointManager(tmp_path / "on" / "checkpoints")
    b = CheckpointManager(tmp_path / "off" / "checkpoints")
    assert a.steps == b.steps
    for step in a.steps:
        pa, pb = a.restore(step), b.restore(step)
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert any("trainer telemetry on :" in r.getMessage()
               for r in caplog.records)
    # every epoch root journaled as a trace exemplar
    assert len(list((tmp_path / "on" / "traces").glob("trace-*.json"))) == 2
    assert not (tmp_path / "off" / "traces").exists()

    # TensorBoard: the per-epoch scalars the JAX package writes
    ea = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    acc = ea.EventAccumulator(str(tmp_path / "on" / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train_loss", "val_loss", "train_F1Score",
            "val_F1Score"} <= tags
    tuning = [json.loads(line) for line in
              (tmp_path / "on" / "tuning.jsonl").read_text().splitlines()
              if "epoch" in json.loads(line)]
    got = [e.value for e in acc.Scalars("val_F1Score")]
    np.testing.assert_allclose(got, [t["val_F1Score"] for t in tuning],
                               rtol=1e-6)
    assert [e.step for e in acc.Scalars("val_F1Score")] == [0, 1]
