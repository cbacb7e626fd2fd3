"""The port's cross-project k-fold protocol
(``deepdfa_tpu_torch/run_cross_project.py``) against the JAX script
(``scripts/run_cross_project.py``), on the CPU.

Both run one fold over the demo corpus (80 functions, one epoch) in
storage trees of their own, with the fold's split files written as
``tests/test_preprocess.py`` writes them: "project A" (ids 0..59, mixed
train/valid/test) and "project B" (ids 60..79, the holdout). Checked:

- ``cross_project.json`` has the JAX script's keys, and each F1 is a
  number;
- the fold's shards carry the fold's named split: ``splits.json`` the JAX
  script's, id for id in each partition, none of the holdout ids in it;
- the vocabulary is the fold's own, byte for byte the JAX script's
  ``vocab.json`` (built from the fold's train partition) and not the one
  a random split builds;
- the holdout test scores exactly the holdout rows (20), the mixed test
  the fold's test partition, as the JAX script's tests do.
"""

import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from deepdfa_tpu_torch import preprocess, run_cross_project  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N = 80
CUT = 60
FOLD = "cross_project_fold_0"
ARGS = ["--dataset", "demo", "--folds", "1", "--n", str(N),
        "--set", "optim.max_epochs=1"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_run_cross_project", REPO / "scripts" / "run_cross_project.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fold_csvs(root: Path) -> None:
    """Fold-0 split files in the reference's csv shape (a leading
    row-index column)."""
    splits_dir = root / "external" / "splits"
    splits_dir.mkdir(parents=True, exist_ok=True)
    rows_ds = [",example_index,split"]
    rows_ho = [",example_index,split"]
    for i in range(CUT):
        part = "valid" if i % 10 == 8 else "test" if i % 10 == 9 else "train"
        rows_ds.append(f"{i},{i},{part}")
        rows_ho.append(f"{i},{i},train")
    for j, i in enumerate(range(CUT, N)):
        rows_ho.append(f"{CUT + j},{i},holdout")
    (splits_dir / f"{FOLD}_dataset.csv").write_text("\n".join(rows_ds))
    (splits_dir / f"{FOLD}_holdout.csv").write_text("\n".join(rows_ho))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's protocol over its own storage tree: (aggregate,
    storage root)."""
    out = {}
    for side in ("jax", "port"):
        root = tmp_path_factory.mktemp(side)
        _fold_csvs(root)
        argv = ARGS + ["--out", str(root / "xp")]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DEEPDFA_STORAGE", str(root))
            mp.chdir(root)
            if side == "jax":
                agg = _jax_script().main(argv)
            else:
                agg = run_cross_project.main(argv + ["--device", "cpu"])
        out[side] = (agg, root)
    return out


def _shards(root: Path) -> Path:
    return root / "processed" / "demo" / "shards"


def test_the_aggregate_has_the_jax_scripts_keys(runs):
    got, root = runs["port"]
    want, _ = runs["jax"]
    assert set(got) == set(want)
    assert got["dataset"] == want["dataset"] == "demo"
    assert got["protocol"] == want["protocol"]
    assert set(got["folds"]) == set(want["folds"]) == {"fold_0"}
    assert set(got["folds"]["fold_0"]) == set(want["folds"]["fold_0"])
    f0 = got["folds"]["fold_0"]
    assert all(isinstance(v, float) for v in f0.values())
    assert got["holdout_f1_mean"] == round(f0["holdout_test_f1"], 4)
    assert json.loads((root / "xp" / "cross_project.json").read_text()) == got


def test_the_fold_shards_carry_the_named_split(runs):
    want = json.loads((_shards(runs["jax"][1]) / "splits.json").read_text())
    got = json.loads((_shards(runs["port"][1]) / "splits.json").read_text())
    assert got == want
    assigned = {int(i) for part in ("train", "val", "test")
                for i in got[part]}
    assert assigned and not assigned & set(range(CUT, N))


def test_the_vocabulary_is_the_folds_own(runs, tmp_path, monkeypatch):
    got = (_shards(runs["port"][1]) / "vocab.json").read_bytes()
    assert got == (_shards(runs["jax"][1]) / "vocab.json").read_bytes()
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    preprocess.main(["--dataset", "demo", "--n", str(N), "--workers", "1"])
    assert (_shards(tmp_path) / "vocab.json").read_bytes() != got


def test_the_holdout_test_scores_exactly_the_holdout_rows(runs):
    counts = {}
    for side, (_, root) in runs.items():
        fold = root / "xp" / "fold_0"
        counts[side] = tuple(json.loads((d / "test_metrics.json").read_text())
                             ["n_graphs_scored"]
                             for d in (fold, fold / "holdout"))
    assert counts["port"] == counts["jax"]
    mixed, held = counts["port"]
    assert held == N - CUT
    assert mixed == sum(1 for i in range(CUT) if i % 10 == 9)
