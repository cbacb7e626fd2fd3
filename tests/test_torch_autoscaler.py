"""The port's fleet autoscaler (``deepdfa_tpu_torch/serve/autoscaler.py``)
against the JAX package's, on the CPU.

The JAX module imports no JAX. Both ``Autoscaler`` classes run the same
scenario on copies of the JAX tests' stub router, launcher and virtual
clock (copied here, not imported), and their decision lists, the stubs'
records (spawns, ring membership, drains and kills) and summaries are
equal, exactly: the dead band, streaks, a dip that resets a streak,
flapping, the cooldown, the min and max clamps, scale-down's ring exit
then flag-only drain, the heal of a dead replica, the spawn fault's retry
with backoff and its exhaustion, the injected crash and ``stop``.
``max_fast_burn`` gives equal results on the same ``/slo`` texts. No
socket, no sleep: the clock advances only through the stubs.
"""

import contextlib

import pytest

from deepdfa_tpu.config import AutoscaleConfig as JAutoscaleConfig
from deepdfa_tpu.resilience import faults as jfaults
from deepdfa_tpu.serve import autoscaler as jauto

from deepdfa_tpu_torch.config import AutoscaleConfig
from deepdfa_tpu_torch.obs import SLOEngine, serve_specs
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.serve import autoscaler as tauto

PKGS = {"jax": (jauto, JAutoscaleConfig, jfaults),
        "torch": (tauto, AutoscaleConfig, faults)}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


class _FakeHandle:
    def __init__(self, name, join_cold_compiles=0):
        self.host, port = name.rsplit(":", 1)
        self.port = int(port)
        self.name = name
        self.join_cold_compiles = join_cold_compiles
        self.exit_code = None
        self.drained = False
        self.killed = False

    def poll(self):
        return self.exit_code

    def drain(self):
        self.drained = True

    def kill(self):
        self.killed = True
        self.exit_code = 137


class _FakeRouter:
    """Membership book-keeping only: a backend is ready the instant it is
    added."""

    def __init__(self):
        self.states = {}
        self.added = []
        self.removed = []

    def add_backend(self, spec):
        name = str(spec)
        self.states[name] = "ready"
        self.added.append(name)

    def remove_backend(self, name):
        self.removed.append(name)
        return self.states.pop(name, None) is not None

    def probe_once(self):
        return dict(self.states)


class _FakeLauncher:
    def __init__(self):
        self.count = 0
        self.handles = []

    def spawn(self):
        self.count += 1
        h = _FakeHandle(f"127.0.0.1:{9000 + self.count}")
        self.handles.append(h)
        return h


class _Journal:
    def __init__(self):
        self.records = []

    def write(self, **fields):
        self.records.append(fields)


class _Flight:
    def __init__(self):
        self.events = []

    def record(self, name, **fields):
        self.events.append((name, fields))


DEFAULTS = dict(min_replicas=1, max_replicas=3, poll_interval_s=1.0,
                burn_high=2.0, burn_low=0.5, up_consecutive=2,
                down_consecutive=3, cooldown_s=10.0, replace_deadline_s=30.0,
                spawn_attempts=3, spawn_backoff_s=0.5)


class _Run:
    """One package's autoscaler on the stubs, its burn a script."""

    def __init__(self, pkg, **cfg_kw):
        mod, cfg_cls, self.faults = PKGS[pkg]
        self.clock, self.router = _Clock(), _FakeRouter()
        self.launcher = _FakeLauncher()
        self.journal, self.flight = _Journal(), _Flight()
        self.burn = 1.0
        self.scaler = mod.Autoscaler(
            cfg_cls(enabled=True, **{**DEFAULTS, **cfg_kw}), self.router,
            self.launcher, journal=self.journal, flight=self.flight,
            scrape=lambda handle: self.burn, clock=self.clock,
            sleep=self.clock.sleep)
        self.made = []

    def tick(self, n=1, burn=None, dt=1.0):
        if burn is not None:
            self.burn = burn
        for _ in range(n):
            self.clock.t += dt
            self.made.append(self.scaler.poll_once())

    @contextlib.contextmanager
    def armed(self, spec):
        with self.faults.installed(spec):
            yield

    def record(self):
        return {"made": self.made, "summary": self.scaler.summary(),
                "spawned": self.launcher.count,
                "added": self.router.added, "removed": self.router.removed,
                "states": self.router.states,
                "handles": [(h.name, h.drained, h.killed)
                            for h in self.launcher.handles],
                "journal": self.journal.records,
                "flight": self.flight.events, "t": self.clock.t}


def _dead_band(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(20, burn=1.0)


def _streak(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(2, burn=3.0)
    r.tick(1, burn=1.0)  # one in-band poll clears the streak
    r.tick(3, burn=3.0)


def _flapping(r):
    r.made.append(r.scaler.ensure_min())
    for _ in range(10):
        r.tick(1, burn=3.0)
        r.tick(1, burn=0.1)


def _cooldown(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(2, burn=3.0)
    r.tick(5, burn=3.0)  # the streak re-arms; the cooldown gates it
    r.clock.t += 10.0
    r.tick(1, burn=3.0)


def _max_clamp(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(2, burn=3.0)
    r.clock.t += 2.0
    r.tick(4, burn=3.0)


def _min_clamp(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(4, burn=0.1)


def _scale_down(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(1, burn=3.0)
    r.clock.t += 2.0
    r.tick(2, burn=0.1)
    r.tick(1, burn=None)


def _heal(r):
    r.made.append(r.scaler.ensure_min())
    r.launcher.handles[0].exit_code = 137  # died between polls
    r.tick(1, burn=1.0)


def _spawn_retry(r):
    with r.armed("autoscale.spawn_fail@1,2"):
        r.made.append(r.scaler.ensure_min())


def _spawn_exhausted(r):
    with r.armed("autoscale.spawn_fail"):
        r.made.append(r.scaler.ensure_min())
    r.tick(1, burn=1.0)  # give-ups are per tick: the next retries


def _crash(r):
    r.made.append(r.scaler.ensure_min())
    with r.armed("autoscale.replica_crash@1"):
        r.tick(1, burn=1.0)


def _crash_then_failed_heal(r):
    r.made.append(r.scaler.ensure_min())
    with r.armed("autoscale.replica_crash@1;autoscale.spawn_fail@1"):
        r.tick(1, burn=1.0)
    r.tick(1, burn=3.0)


def _stop(r):
    r.made.append(r.scaler.ensure_min())
    r.tick(1, burn=3.0)
    r.made.append([r.scaler.stop(drain=True)])


SCENARIOS = {
    "dead_band": (_dead_band, {}),
    "streak_reset": (_streak, dict(up_consecutive=3)),
    "flapping": (_flapping, dict(down_consecutive=2)),
    "cooldown": (_cooldown, dict(max_replicas=5)),
    "max_clamp": (_max_clamp, dict(max_replicas=2, cooldown_s=1.0)),
    "min_clamp": (_min_clamp, dict(down_consecutive=2)),
    "scale_down": (_scale_down, dict(up_consecutive=1, down_consecutive=2,
                                     cooldown_s=1.0)),
    "heal": (_heal, dict(cooldown_s=1000.0)),
    "spawn_retry": (_spawn_retry, {}),
    "spawn_exhausted": (_spawn_exhausted, dict(spawn_backoff_s=0.1)),
    "crash": (_crash, dict(min_replicas=2)),
    "crash_failed_heal": (_crash_then_failed_heal,
                          dict(min_replicas=2, up_consecutive=1)),
    "stop": (_stop, dict(min_replicas=2, up_consecutive=1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_jax(name):
    scenario, cfg_kw = SCENARIOS[name]
    out = {}
    for pkg in PKGS:
        run = _Run(pkg, **cfg_kw)
        scenario(run)
        out[pkg] = run.record()
    assert out["torch"] == out["jax"]


def test_the_scenarios_reach_their_decisions():
    """What the equal lists hold: each scenario's own decision."""
    def actions(name):
        scenario, cfg_kw = SCENARIOS[name]
        run = _Run("torch", **cfg_kw)
        scenario(run)
        return run, [d["action"] for made in run.made for d in made
                     if "action" in d]

    run, acts = actions("dead_band")
    assert acts == ["scale_up"] and run.launcher.count == 1
    run, acts = actions("streak_reset")
    assert acts == ["scale_up", "scale_up"]
    run, acts = actions("cooldown")
    assert acts.count("scale_up") == 3
    run, acts = actions("max_clamp")
    assert "hold" in acts and run.launcher.count == 2
    run, acts = actions("min_clamp")
    assert acts[-1] == "hold" and not run.launcher.handles[0].drained
    run, acts = actions("scale_down")
    victim = run.launcher.handles[-1]
    assert "scale_down" in acts and victim.drained and not victim.killed
    assert victim.name in run.router.removed
    run, acts = actions("heal")
    replace = run.scaler.summary()["decisions"][-1]
    assert replace["action"] == "replace" and replace["exit_code"] == 137
    assert replace["replace_latency_s"] <= DEFAULTS["replace_deadline_s"]
    run, acts = actions("spawn_retry")
    assert acts == ["scale_up"] and run.clock.t >= 0.5  # backed off
    run, acts = actions("spawn_exhausted")
    assert [d["action"] for d in run.scaler.summary()["decisions"]] == [
        "spawn_give_up", "scale_up"]
    run, acts = actions("crash")
    assert acts[-2:] == ["replica_crash_injected", "replace"]
    run, acts = actions("stop")
    assert all(h.drained and not h.killed for h in run.launcher.handles)


@pytest.mark.parametrize("text", [
    'deepdfa_serve_slo_burn_rate{slo="latency_p99",window="fast"} 1.5\n'
    'deepdfa_serve_slo_burn_rate{slo="latency_p99",window="slow"} 9.0\n'
    'deepdfa_serve_slo_burn_rate{slo="availability",window="fast"} 2.5\n'
    'deepdfa_serve_slo_burn_rate{slo="errors",window="fast"} NaN\n',
    "", 'x_burn_rate{window="slow"} 3.0',
    'a_slo_burn_rate{window="fast"} abc\nb_slo_burn_rate{window="fast"} 0\n',
    'a_slo_burn_rate{window="fast",slo="x"} +Inf\n',
    None,
])
def test_max_fast_burn_equals_jax(text):
    assert tauto.max_fast_burn(text) == jauto.max_fast_burn(text)


def test_max_fast_burn_reads_a_rendered_slo_body():
    """The body a replica's ``/slo`` serves, its error ratio burning."""
    now = [100.0]
    engine = SLOEngine(serve_specs(), fast_window_s=2.0, slow_window_s=4.0,
                       clock=lambda: now[0])
    for total, errors in [(0, 0), (10, 5), (20, 10)]:
        now[0] += 1.0
        engine.observe({"responses_total": total,
                        "responses_5xx_total": 0,
                        "responses_error_total": errors,
                        "latency_p99_ms": 10.0, "drift_alerting": 0})
    text = engine.render("deepdfa_serve_")
    burn = tauto.max_fast_burn(text)
    assert burn == jauto.max_fast_burn(text) and burn > 2.0
