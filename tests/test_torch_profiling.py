"""The port's profiler (``deepdfa_tpu_torch/train/profiling.py``), the
hand-written kernels' FLOP formulas (``deepdfa_tpu_torch/ops/flops.py``)
and ``test``'s ``profile``/``time``/``trace`` against the JAX package, on
the CPU.

- ``report`` on the same jsonl files equals the JAX ``report``, and
  ``StepProfiler`` writes the JAX rows;
- each kernel's formula (B1-B6b) equals ``FlopCounterMode`` on its plain
  version at three shapes, the registered ops carry theirs, and
  ``flops.count`` reports to an active counter;
- ``test --set profile=true time=true trace=true`` returns the JAX
  ``test``'s keys on a demo corpus (one fused fit, as
  ``tests/test_torch_trainer_cli.py`` makes it), with ``test_*`` metrics
  bitwise those of the unprofiled run, and writes the Chrome trace;
- ``performance_evaluation`` fills its profiled keys.

Tolerances: the reports and FLOP counts exact; the metrics bitwise.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.train import checkpoint as jckpt  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import profiling as jprof  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch.config import load_config  # noqa: E402
from deepdfa_tpu_torch.ops import custom_ops, flops  # noqa: E402
from deepdfa_tpu_torch.ops import fused_ggnn as fg  # noqa: E402
from deepdfa_tpu_torch.ops import megabatch as mb  # noqa: E402
from deepdfa_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_backward_reference, flash_attention_forward,
    flash_attention_reference)
from deepdfa_tpu_torch.ops.int8_matmul import int8_matmul_reference  # noqa: E402
from deepdfa_tpu_torch.train import cli, profiling  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

OVERRIDES = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.dsname": "demo", "data.split": "random",
    "data.undersample": None, "data.feature.limit_all": 50,
    "data.feature.limit_subkeys": 50, "data.batch.batch_graphs": 16,
    "optim.max_epochs": 1}
SETS = [a for k, v in OVERRIDES.items()
        for a in ("--set", f"{k}={json.dumps(v)}")]
PROFILED = ["--set", "profile=true", "--set", "time=true"]


def _counted(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as mode:
        fn(*args, **kwargs)
    return mode.get_total_flops()


# ------------------------------------------------------------------ report


def _rows(rng, n, warm_all=False):
    prof, timed = [], []
    for i in range(1, n + 1):
        warmup = warm_all or i <= 2
        size = int(rng.integers(1, 17))
        f = float(rng.integers(1, 10**9))
        prof.append({"batch": i, "flops": f, "macs": f / 2,
                     "batch_size": size, "warmup": warmup})
        timed.append({"batch": i, "ms": float(rng.uniform(0.1, 50.0)),
                      "batch_size": size, "warmup": warmup})
    return prof, timed


@pytest.mark.parametrize("case", ["steady", "only_warmup", "time_only"])
def test_report_equals_the_jax_report(tmp_path, case):
    prof, timed = _rows(np.random.default_rng(len(case)), 7,
                        warm_all=case == "only_warmup")
    if case != "time_only":
        (tmp_path / "profiledata.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in prof))
    (tmp_path / "timedata.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in timed) + "\n")
    got, want = profiling.report(tmp_path), jprof.report(tmp_path)
    assert got == want and list(got) == list(want)
    assert ("gflops_per_example" in got) == (case != "time_only")


def test_step_profiler_writes_the_jax_rows(tmp_path):
    port = profiling.StepProfiler(tmp_path / "port")
    jax_ = jprof.StepProfiler(tmp_path / "jax")
    for i, size in enumerate((4, 3, 5)):
        out = port.step(lambda x: x * 2, torch.ones(3), batch_size=size,
                        flops=None if i == 1 else 100.0 * (i + 1))
        jax_.step(lambda x: x * 2, np.ones(3), batch_size=size,
                  flops=None if i == 1 else 100.0 * (i + 1))
        assert torch.equal(out, 2 * torch.ones(3))
    for name in ("profiledata.jsonl", "timedata.jsonl"):
        got = [json.loads(line) for line in
               port.flush()[0].parent.joinpath(name).read_text().splitlines()]
        jax_.flush()
        want = [json.loads(line) for line in
                (tmp_path / "jax" / name).read_text().splitlines()]
        strip = [{k: v for k, v in r.items() if k != "ms"} for r in got]
        assert strip == [{k: v for k, v in r.items() if k != "ms"}
                         for r in want]
        assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["warmup"] for r in want] == [True, True, False]


# ---------------------------------------------------------------- formulas


def _ggnn_args(gen, n, e, d):
    h0 = torch.randn(n, d, generator=gen)
    senders = torch.randint(0, n, (e,), generator=gen)
    receivers = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
    ws = [torch.randn(*s, generator=gen) for s in
          ((d, d), (d,), (d, 3 * d), (3 * d,), (d, 3 * d), (3 * d,))]
    return h0, senders, receivers, ws


SHAPES = [0, 1, 2]
GGNN = [(37, 50, 8, 3), (5, 0, 4, 1), (120, 300, 16, 5)]
MEGA = [(40, 60, 8, 3, 4, 2), (9, 12, 4, 1, 2, 1), (130, 250, 16, 5, 7, 3)]
INT8 = [((10, 12), 7), ((2, 5, 16), 9), ((1, 64), 128)]
ATTN = [(2, 16, 4, 2, 16), (1, 32, 2, 2, 32), (3, 8, 6, 3, 16)]


@pytest.mark.parametrize("i", SHAPES)
def test_b1_formula_equals_its_plain_version(i):
    n, e, d, steps = GGNN[i]
    h0, snd, rcv, ws = _ggnn_args(torch.Generator().manual_seed(i), n, e, d)
    want = _counted(fg.fused_ggnn_reference, h0, snd, rcv, *ws,
                    n_steps=steps)
    assert flops.fused_ggnn_flops(n, d, steps) == want
    # the registered op carries the formula (its inner products unseen)
    assert _counted(custom_ops.fused_ggnn, h0, snd, rcv, *ws, steps) == want


@pytest.mark.parametrize("i", SHAPES)
def test_b2_formula_equals_its_plain_version(i):
    n, e, d, steps = GGNN[i]
    gen = torch.Generator().manual_seed(10 + i)
    h0, snd, rcv, ws = _ggnn_args(gen, n, e, d)
    g = torch.randn(n, d, generator=gen)
    want = _counted(fg.fused_ggnn_backward_reference, h0, snd, rcv, *ws, g,
                    n_steps=steps)
    assert flops.fused_ggnn_backward_flops(n, d, steps) == want


def _mega_args(gen, n, e, d, steps, g, layers):
    n_sub, ed, vocab = 2, d // 2, 11
    table = torch.randn(n_sub * vocab, ed, generator=gen)
    ids = torch.randint(0, n_sub * vocab, (n, n_sub), generator=gen)
    _, snd, rcv, ws = _ggnn_args(gen, n, e, d)
    gidx = torch.sort(torch.randint(0, g, (n,), generator=gen)).values
    mask = torch.ones(n, dtype=torch.bool)
    gw, gb = torch.randn(2 * d, 1, generator=gen), torch.randn(1,
                                                               generator=gen)
    dims = mb._head_dims(d, layers)
    head = tuple((torch.randn(a, b, generator=gen), torch.randn(b,
                                                                generator=gen))
                 for a, b in zip(dims[:-1], dims[1:]))
    return (table, ids, snd, rcv, gidx, mask, *ws, gw, gb), head, dims


@pytest.mark.parametrize("i", SHAPES)
def test_b3_formula_equals_its_plain_version(i):
    n, e, d, steps, g, layers = MEGA[i]
    args, head, dims = _mega_args(torch.Generator().manual_seed(20 + i), n,
                                  e, d, steps, g, layers)
    want = _counted(mb.megabatch_reference, *args, head, n_steps=steps,
                    n_graphs=g)
    assert flops.megabatch_flops(n, d, steps, g, dims) == want


@pytest.mark.parametrize("i", SHAPES)
def test_b4_formula_equals_its_plain_version(i):
    n, e, d, steps, g, _ = MEGA[i]
    args, _, _ = _mega_args(torch.Generator().manual_seed(30 + i), n, e, d,
                            steps, g, 0)
    want = _counted(mb.megabatch_encoder_reference, *args, n_steps=steps,
                    n_graphs=g)
    assert flops.megabatch_flops(n, d, steps, g, mb._head_dims(d, 0)) == want


@pytest.mark.parametrize("i", SHAPES)
def test_b5_formula_equals_its_plain_version(i):
    xshape, n = INT8[i]
    gen = torch.Generator().manual_seed(40 + i)
    x = torch.randn(*xshape, generator=gen)
    q = torch.randint(-127, 128, (xshape[-1], n), generator=gen,
                      dtype=torch.int8)
    scale = torch.rand(n, generator=gen)
    want = _counted(int8_matmul_reference, x, q, scale)
    m = int(np.prod(xshape[:-1]))
    assert flops.int8_matmul_flops(m, xshape[-1], n) == want
    assert _counted(custom_ops.int8_matmul, x, q, scale,
                    torch.float32) == want


def _attn(gen, b, s, h, h_kv, d):
    return (torch.randn(b, s, h, d, generator=gen),
            torch.randn(b, s, h_kv, d, generator=gen),
            torch.randn(b, s, h_kv, d, generator=gen))


@pytest.mark.parametrize("i", SHAPES)
def test_b6_formula_equals_its_plain_version(i):
    b, s, h, h_kv, d = ATTN[i]
    q, k, v = _attn(torch.Generator().manual_seed(50 + i), b, s, h, h_kv, d)
    pad = torch.ones(b, s, dtype=torch.bool)
    pad[0, : s // 2] = False
    want = _counted(flash_attention_reference, q, k, v, pad)
    assert flops.flash_attention_flops(b, s, h, d) == want


@pytest.mark.parametrize("i", SHAPES)
def test_b6b_formula_equals_its_plain_version(i):
    b, s, h, h_kv, d = ATTN[i]
    gen = torch.Generator().manual_seed(60 + i)
    q, k, v = _attn(gen, b, s, h, h_kv, d)
    o, lse = flash_attention_forward(q, k, v, None)
    do = torch.randn(o.shape, generator=gen)
    want = _counted(flash_attention_backward_reference, q, k, v, o, do, lse)
    assert flops.flash_attention_backward_flops(b, s, h, d) == want


def test_the_segment_sum_op_counts_nothing_and_count_reports_its_argument():
    data, ids = torch.randn(9, 4), torch.tensor([0, 0, 1, 1, 1, 2, 2, 3, 3])
    assert _counted(custom_ops.segment_sum, data, ids, 4) == 0
    assert _counted(flops.count, 1234, data) == 1234
    flops.count(5, data)  # no active counter: nothing happens
    # a counter is this thread's: another thread's reports reach it not
    with FlopCounterMode(display=False) as mode:
        with ThreadPoolExecutor(max_workers=1) as other:
            other.submit(flops.count, 99, data).result()
        flops.count(7, data)
    assert mode.get_total_flops() == 7


def test_flops_of_counts_once_and_feeds_nothing():
    gen = torch.Generator().manual_seed(7)
    h0, snd, rcv, ws = _ggnn_args(gen, 30, 40, 8)
    calls = []

    def step(h):
        calls.append(1)
        return fg.fused_ggnn(h, snd, rcv, *ws, n_steps=2) @ ws[0]

    got = profiling.flops_of(step, h0)
    assert got == float(flops.fused_ggnn_flops(30, 8, 2) + 2 * 30 * 8 * 8)
    assert calls == [1]
    assert profiling.flops_of(lambda x: x + 1, h0) is None


def test_a_counted_step_records_its_flops_and_returns_its_output(tmp_path):
    """``StepProfiler.step(count=True)`` counts the profiled call itself:
    the row holds its count, and its output is bitwise the uncounted
    call's."""
    gen = torch.Generator().manual_seed(8)
    h0, snd, rcv, ws = _ggnn_args(gen, 30, 40, 8)

    def step(h):
        return fg.fused_ggnn(h, snd, rcv, *ws, n_steps=2) @ ws[0]

    prof = profiling.StepProfiler(tmp_path)
    counted = prof.step(step, h0, batch_size=3, count=True)
    want = float(flops.fused_ggnn_flops(30, 8, 2) + 2 * 30 * 8 * 8)
    assert prof.last_flops == want
    assert torch.equal(counted, prof.step(step, h0, batch_size=3,
                                          flops=prof.last_flops))
    rows = [json.loads(line) for line in
            prof.flush()[0].read_text().splitlines()]
    assert [r["flops"] for r in rows] == [want, want]


# ---------------------------------------------------------------- test cmd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Demo shards (80 functions) under a storage root of the module's and
    one fused fit of one epoch through ``cli.main``."""
    root = tmp_path_factory.mktemp("storage")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        preprocess.main(["--dataset", "demo", "--n", "80", "--workers", "1",
                         "--limit-all", "50", "--limit-subkeys", "50"])
        run = tmp_path_factory.mktemp("fit")
        cli.main(["fit", "--run-dir", str(run), *SETS, "--device", "cpu"])
        yield run


def _jax_checkpoint(run: Path, out: Path) -> Path:
    cfg = load_config(overrides=OVERRIDES)
    mgr = CheckpointManager(run / "checkpoints")
    tree = bridge.torch_to_flax(mgr.restore(mgr.best_step()), cfg.model,
                                cfg.input_dim)
    jdir = out / "jax_ckpt"
    jckpt.CheckpointManager(jdir).save(1, {"params": tree},
                                       metrics={"val_loss": 0.0}, epoch=0)
    return jdir


def _test(run: Path, out: Path, *extra):
    return cli.main(["test", "--run-dir", str(out), "--ckpt-dir",
                     str(run / "checkpoints"), *SETS, *extra, "--device",
                     "cpu"])


def test_profiled_test_has_the_jax_keys_and_the_same_metrics(fitted,
                                                            tmp_path):
    plain = _test(fitted, tmp_path / "plain")
    got = _test(fitted, tmp_path / "profiled", *PROFILED, "--set",
                "trace=true")
    jout = tmp_path / "jax"
    jout.mkdir()
    jcfg = jload_config(overrides=OVERRIDES | {"model.layout": "segment",
                                               "profile": True,
                                               "time": True})
    want = jcli.test(jcfg, jout, _jax_checkpoint(fitted, tmp_path))
    assert got.keys() == want.keys()
    assert {k for k in got if k.startswith("profile_")} == {
        "profile_gflops_per_example", "profile_gmacs_per_example",
        "profile_ms_per_example", "profile_examples_per_sec"}
    assert all(got[k] > 0 for k in got if k.startswith("profile_"))
    # the profiled run's metrics are bitwise the unprofiled run's
    assert {k: v for k, v in got.items() if not k.startswith("profile_")} \
        == plain
    rows = [json.loads(line) for line in (tmp_path / "profiled" /
                                          "profiledata.jsonl").read_text()
            .splitlines()]
    assert [r["batch"] for r in rows] == list(range(1, len(rows) + 1))
    assert all(r["macs"] == r["flops"] / 2 > 0 for r in rows)
    trace = json.loads((tmp_path / "profiled" / "trace" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]


def test_time_alone_writes_no_flops(fitted, tmp_path):
    got = _test(fitted, tmp_path / "timed", "--set", "time=true")
    assert "profile_examples_per_sec" in got
    assert "profile_gflops_per_example" not in got
    assert (tmp_path / "timed" / "profiledata.jsonl").read_text() == ""


def test_performance_evaluation_fills_its_profiled_keys(fitted, tmp_path):
    from deepdfa_tpu_torch import performance_evaluation

    got = performance_evaluation.main(
        ["--runs", "1", "--out", str(tmp_path), *SETS, "--set",
         "data.sample=false", "--device", "cpu"])
    run = got["runs"][0]
    assert run["profile_examples_per_sec"] > 0
    assert run["profile_gflops_per_example"] > 0
