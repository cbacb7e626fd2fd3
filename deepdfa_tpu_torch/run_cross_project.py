"""The cross-project k-fold protocol (the reference's
``DDFA/scripts/run_cross_project.sh``).

The port of ``scripts/run_cross_project.py``. Each fold runs end to end:

1. ``preprocess --split cross_project_fold_{i}_dataset --overwrite``: the
   fold's split is applied when the shards are built, so the vocabulary
   (built from the train partition) is the fold's own;
2. ``fit`` on the fold's shards;
3. ``test`` twice: under the shards' split, and with the holdout split
   applied at load time (``--set data.split=cross_project_fold_{i}_holdout``;
   shards and vocabulary unchanged, the reference's test-time re-split).

Split files live at ``external/splits/<name>.csv`` under the storage root,
columns ``example_index, split`` (``train``/``valid``/``test``/``holdout``;
``holdout`` counts as ``test``). Writes ``cross_project.json`` (the JAX
script's keys) into ``--out`` (default ``<storage>/cross_project``), each
fold's runs under ``fold_{i}/`` (the holdout test's ``test_metrics.json``
under ``fold_{i}/holdout/``), and prints it as one JSON line.

Usage::

    python -m deepdfa_tpu_torch.run_cross_project --dataset bigvul \\
        [--folds 5] [--set k=v ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="bigvul")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--n", type=int, default=200,
                    help="demo corpus size (hermetic runs)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[], dest="overrides")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default=None,
                    help="fit and test on this device (default cuda)")
    args = ap.parse_args(argv)

    from deepdfa_tpu_torch import preprocess, utils
    from deepdfa_tpu_torch.train import cli

    out_dir = (Path(args.out) if args.out
               else utils.storage_dir() / "cross_project")
    out_dir.mkdir(parents=True, exist_ok=True)
    sets = [x for o in (f"data.dsname={args.dataset}",
                        *(("data.sample=true",) if args.sample else ()),
                        *args.overrides) for x in ("--set", o)]
    device = ["--device", args.device] if args.device else []

    folds: dict[str, dict] = {}
    for i in range(args.folds):
        ds_split = f"cross_project_fold_{i}_dataset"
        holdout_split = f"cross_project_fold_{i}_holdout"
        # the fold's split defines its vocabulary (--overwrite: shards
        # carry one split; the extraction cache stays warm)
        pp_args = ["--dataset", args.dataset, "--split", ds_split,
                   "--overwrite"]
        if args.dataset.startswith("demo"):
            pp_args += ["--n", str(args.n)]
        if args.sample:
            pp_args += ["--sample"]
        summary = preprocess.main(pp_args)
        if summary.get("status") not in ("ok", "exists"):
            raise SystemExit(f"fold {i} preprocess failed: {summary}")

        fold_dir = out_dir / f"fold_{i}"
        ckpts = str(fold_dir / "checkpoints")
        cli.main(["fit", "--run-dir", str(fold_dir), *sets, *device])
        mixed = cli.main(["test", "--run-dir", str(fold_dir),
                          "--ckpt-dir", ckpts, *sets, *device])
        held = cli.main(["test", "--run-dir", str(fold_dir / "holdout"),
                         "--ckpt-dir", ckpts, *sets, "--set",
                         f"data.split={holdout_split}", *device])
        folds[f"fold_{i}"] = {
            "mixed_test_f1": mixed.get("test_F1Score"),
            "holdout_test_f1": held.get("test_F1Score"),
        }
        print(f"fold {i}: mixed={mixed.get('test_F1Score')} "
              f"holdout={held.get('test_F1Score')}", file=sys.stderr)

    vals = [f["holdout_test_f1"] for f in folds.values()
            if f["holdout_test_f1"] is not None]
    agg = {
        "protocol": "cross-project k-fold (run_cross_project.sh parity): "
                    "per-fold preprocess+vocab, fit, mixed test, holdout test",
        "dataset": args.dataset,
        "folds": folds,
        "holdout_f1_mean": round(sum(vals) / len(vals), 4) if vals else None,
    }
    (out_dir / "cross_project.json").write_text(json.dumps(agg, indent=2))
    print(json.dumps(agg), flush=True)
    return agg


if __name__ == "__main__":
    main()
