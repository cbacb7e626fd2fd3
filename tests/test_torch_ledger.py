"""The port's perf-regression ledger (``deepdfa_tpu_torch/obs/ledger.py``)
against the JAX package's, on the CPU. Everything is exact: the module is
standard library only and both packages read the same files.

- the repo's ``BENCH_*.json`` and ``MULTICHIP_*.json``: equal entries,
  verdicts, ``check()`` and ``trend_lines()``; ``main --check`` and
  ``train.cli bench ledger --check`` return the JAX package's rc;
- synthetic histories (a 20 % regression, a wobble inside the band, a
  higher-is-better drop, a young series, two device kinds, a declared
  direction): equal verdict rows, trend lines, ``--check`` rc and
  ``--trend`` output;
- every historical artifact shape through ``iter_entries``; the
  append-only store's backfill; ``EXPLICIT_SERIES`` and
  ``lower_is_better``.
"""

import dataclasses
import json
from pathlib import Path

import pytest

from deepdfa_tpu.obs import ledger as jledger
from deepdfa_tpu.train import cli as jcli

from deepdfa_tpu_torch.obs import ledger
from deepdfa_tpu_torch.train import cli

REPO = Path(__file__).resolve().parent.parent


def _art(dirpath: Path, name: str, emitted: int, device="cpu", **metrics):
    doc = {"schema_version": 1, "git_rev": "ab" * 20, "git_dirty": False,
           "emitted_at_unix": emitted, "device_kind": device, **metrics}
    (dirpath / name).write_text(json.dumps(doc))
    return dirpath / name


def _history(dirpath: Path, values, metric="step_ms", device="cpu"):
    for i, v in enumerate(values):
        _art(dirpath, f"BENCH_t{i:02d}.json", emitted=1000 + i,
             device=device, **{metric: v})


def _rows(entries):
    return [dataclasses.astuple(e) for e in entries]


def _scenario_regression(d):
    _history(d, [100.0, 101.0, 99.0, 100.0, 120.0])


def _scenario_wobble(d):
    _history(d, [100.0, 101.0, 99.0, 100.0, 105.0])


def _scenario_higher_is_better(d):
    _history(d, [300.0, 305.0, 295.0, 300.0, 240.0], metric="graphs_per_sec")
    _art(d, "BENCH_u99.json", emitted=2000, g2=380.0)


def _scenario_young(d):
    _history(d, [100.0, 900.0])


def _scenario_devices(d):
    _history(d, [10.0, 10.0, 10.0, 10.0], device="TPU v5e")
    _art(d, "BENCH_cpu.json", emitted=5000, device="cpu", step_ms=900.0)


def _scenario_declared(d):
    for i, v in enumerate([0.0, 0.0, 1.0, 0.0]):
        _art(d, f"BENCH_e{i:02d}.json", emitted=1000 + i,
             extraction={"quarantined": v, "cache_hit_rate": 1.0},
             ggnn_megabatch={"dispatches_per_step": 12.0},
             promotion={"rollout_seconds": 1.5, "join_cold_compiles": 0})
    _art(d, "BENCH_e99.json", emitted=2000,
         extraction={"quarantined": 9.0, "cache_hit_rate": 1.0},
         ggnn_megabatch={"dispatches_per_step": 3.0},
         promotion={"rollout_seconds": 9.0, "join_cold_compiles": 1})


SCENARIOS = {"regression": _scenario_regression, "wobble": _scenario_wobble,
             "higher_is_better": _scenario_higher_is_better,
             "young": _scenario_young, "devices": _scenario_devices,
             "declared": _scenario_declared}


def test_the_repo_artifacts_give_jax_entries_verdicts_and_trends():
    mine, ref = ledger.Ledger.from_paths([REPO]), jledger.Ledger.from_paths(
        [REPO])
    assert len(mine.entries) > 50  # BENCH_r01..r05 and the rest ingested
    assert _rows(mine.entries) == _rows(ref.entries)
    assert mine.verdicts() == ref.verdicts()
    assert mine.check() == ref.check()
    assert mine.trend_lines() == ref.trend_lines()
    assert [p.name for p in ledger.discover_artifacts([REPO])] == \
        [p.name for p in jledger.discover_artifacts([REPO])]


def test_check_over_the_repo_returns_the_jax_rc(capsys):
    rc = ledger.main(["--check", str(REPO)])
    out = capsys.readouterr().out
    assert rc == jledger.main(["--check", str(REPO)])
    assert out == capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_synthetic_histories_judge_as_jax(name, tmp_path, capsys):
    SCENARIOS[name](tmp_path)
    mine = ledger.Ledger.from_paths([tmp_path])
    ref = jledger.Ledger.from_paths([tmp_path])
    assert _rows(mine.entries) == _rows(ref.entries)
    assert mine.check() == ref.check()
    assert mine.trend_lines() == ref.trend_lines()
    for flags in (["--check"], ["--trend"], ["--json"]):
        rc = ledger.main(flags + [str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == jledger.main(flags + [str(tmp_path)]), flags
        assert out == capsys.readouterr().out, flags
    if name == "regression":
        assert mine.check()[0] is False
        assert ledger.main(["--check", str(tmp_path)]) == 1


@pytest.mark.parametrize("doc", [
    {"n": 3, "cmd": "python bench.py", "rc": 0, "tail": "...",
     "parsed": {"backend": "tpu", "git_rev": "cd" * 20, "step_ms": 12.5,
                "serving": {"p99_ms": 40.0, "ok": True}}},
    {"n": 5, "cmd": "x", "rc": 1, "tail": "boom", "parsed": None},
    "not a dict",
    {"parsed": 7, "cmd": "x"},
    {"n_devices": 8, "rc": 0, "ok": True, "skipped": False, "tail": "..."},
    {"metric": "serve_requests_per_sec", "value": 50.0, "device_kind": "cpu"},
    {"value": 1.0},
    {"device_kind": "H100", "stage_a": {"x_ms": 1.0, "deep": {"y": 2.0}},
     "flag": False, "ok": False},
])
def test_iter_entries_equals_jax_on_every_shape(doc):
    assert _rows(ledger.iter_entries(doc, source="BENCH_x.json")) == \
        _rows(jledger.iter_entries(doc, source="BENCH_x.json"))


def test_store_backfill_equals_jax(tmp_path):
    _history(tmp_path, [100.0, 101.0])
    entries = ledger.Ledger.from_paths([tmp_path]).entries
    stores = (ledger.LedgerStore(tmp_path / "mine.jsonl"),
              jledger.LedgerStore(tmp_path / "ref.jsonl"))
    ref_entries = jledger.Ledger.from_paths([tmp_path]).entries
    assert stores[0].ingest(entries) == stores[1].ingest(ref_entries) > 0
    assert stores[0].ingest(entries) == 0
    _art(tmp_path, "BENCH_t09.json", emitted=1100, step_ms=99.0)
    assert stores[0].ingest(ledger.Ledger.from_paths([tmp_path]).entries) \
        == stores[1].ingest(jledger.Ledger.from_paths([tmp_path]).entries) \
        == 1
    for store in stores:
        with store.path.open("a") as fh:
            fh.write('{"stage": "torn"')
    assert (tmp_path / "mine.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert _rows(stores[0].load()) == _rows(stores[1].load())


def test_declared_directions_equal_jax():
    assert ledger.EXPLICIT_SERIES == jledger.EXPLICIT_SERIES
    names = ["step_ms", "latency_p99_ms", "wall_s", "psi", "mfu", "ok",
             "graphs_per_sec", "quarantined", "int8_score_delta"]
    stages = [None, "extraction", "promotion", "ggnn_megabatch"]
    for m in names + [m for _, m in ledger.EXPLICIT_SERIES]:
        for s in stages + [s for s, _ in ledger.EXPLICIT_SERIES]:
            assert ledger.lower_is_better(m, s) == \
                jledger.lower_is_better(m, s), (m, s)


def test_bench_ledger_through_both_command_lines(tmp_path, capsys):
    _history(tmp_path, [100.0, 101.0, 99.0, 100.0, 105.0])
    argv = ["bench", "ledger", "--ledger-dir", str(tmp_path), "--check"]
    assert cli.main(argv) == jcli.main(argv) == {
        "command": "bench", "subcommand": "ledger", "rc": 0}
    _art(tmp_path, "BENCH_t99.json", emitted=2000, step_ms=150.0)
    codes = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        codes.append(exc.value.code)
    assert codes == [1, 1]
    capsys.readouterr()
    # bench with the default subcommand, over the repo's artifacts
    argv = ["bench", "--ledger-dir", str(REPO), "--check"]
    assert cli.main(argv) == jcli.main(argv)
    with pytest.raises(SystemExit):
        cli.main(["bench", "nope"])
