"""End-to-end performance evaluation: the reference's protocol.

A copy of ``scripts/performance_evaluation.py``: the same flags and the
same JSON keys, run as ``python -m deepdfa_tpu_torch.performance_evaluation``
on ``--device`` (``cuda`` unless another is named). It writes
``performance_evaluation.json`` under ``--out`` and prints its summary.

- ``--protocol ggnn`` (default): ``--runs`` timed ``train.cli fit`` +
  ``test`` repetitions of the GGNN (sample corpus, 3 epochs unless
  ``--set`` says otherwise), their test F1, the mean, and the committed
  quality band of ``configs/golden_quality.json`` when the protocol
  matches it. ``fit`` and ``test`` run with ``profile=true time=true``, as
  in the JAX script, and each run carries ``test``'s
  ``profile_examples_per_sec`` and ``profile_gflops_per_example``
  (:mod:`deepdfa_tpu_torch.train.profiling`: matrix-product FLOPs from
  ``FlopCounterMode``, not the JAX package's XLA cost analysis, so the two
  packages share these keys' names but not their values).
- ``--protocol full``: the reference's three stages
  (``performance_evaluation.sh``) on the demo sample corpus, timed:
  DeepDFA (``fit``/``test``), LineVul (``train_joint --encoder roberta
  --no_flowgnn``) and DeepDFA + LineVul (``train_joint --encoder roberta
  --freeze-graph`` on the first stage's checkpoints).

Usage: python -m deepdfa_tpu_torch.performance_evaluation [--runs 3]
[--protocol ggnn|full] [--out DIR] [--config cfg.yaml] [--set k=v]
[--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

__all__ = ["full_protocol", "main"]

REPO = Path(__file__).resolve().parent.parent


def _cli(argv: list[str], device: str | None) -> dict:
    from deepdfa_tpu_torch.train import cli

    return cli.main(argv + ([] if device is None else ["--device", device]))


def full_protocol(args, out_dir: Path) -> dict:
    """The three stages, ``--runs`` times; ``stages`` and
    ``total_seconds`` quote the last run, every run is in ``runs``."""
    from deepdfa_tpu_torch import preprocess, resolve_device
    from deepdfa_tpu_torch import train_joint as tj

    preprocess.main(["--dataset", "demo", "--n", "120", "--sample"])
    dev = ([] if args.device is None else ["--device", args.device])
    runs: list[dict] = []
    agg = {"protocol": "full (train DeepDFA; train LineVul; train "
                       "DeepDFA+LineVul - performance_evaluation.sh parity, "
                       "hermetic demo corpus)",
           "backend": resolve_device(args.device).type, "stages": None,
           "total_seconds": None, "runs": runs}
    for i in range(args.runs):
        run_dir = out_dir / f"run_{i}" if args.runs > 1 else out_dir
        stages: dict[str, dict] = {}
        agg["stages"] = stages
        runs.append({"stages": stages, "total_seconds": None})

        def timed(name, fn):
            t0 = time.monotonic()
            out = fn()
            stages[name] = {"seconds": round(time.monotonic() - t0, 2), **out}
            print(json.dumps({name: stages[name]}), file=sys.stderr,
                  flush=True)

        ggnn_dir = run_dir / "deepdfa"
        small = [x for o in ("data.sample=true", "data.dsname=demo",
                             "optim.max_epochs=3", *args.overrides)
                 for x in ("--set", o)]

        def stage_deepdfa():
            _cli(["fit", "--run-dir", str(ggnn_dir), *small], args.device)
            r = _cli(["test", "--run-dir", str(ggnn_dir), "--ckpt-dir",
                      str(ggnn_dir / "checkpoints"), *small], args.device)
            return {"test_F1Score": r.get("test_F1Score")}

        def stage_linevul():
            r = tj.main(["--dataset", "demo", "--sample", "--encoder",
                         "roberta", "--no_flowgnn", "--do_train", "--do_test",
                         "--epochs", "2", "--output_dir",
                         str(run_dir / "linevul"), *dev])
            return {"test_f1_weighted": r.get("test_f1_weighted")}

        def stage_combined():
            r = tj.main(["--dataset", "demo", "--sample", "--encoder",
                         "roberta", "--freeze-graph",
                         str(ggnn_dir / "checkpoints"), "--do_train",
                         "--do_test", "--epochs", "2", "--output_dir",
                         str(run_dir / "combined"), *dev])
            return {"test_f1_weighted": r.get("test_f1_weighted")}

        timed("deepdfa", stage_deepdfa)
        timed("linevul", stage_linevul)
        timed("deepdfa_linevul", stage_combined)
        total = round(sum(s["seconds"] for s in stages.values()), 2)
        runs[-1]["total_seconds"] = agg["total_seconds"] = total
    (out_dir / "performance_evaluation.json").write_text(
        json.dumps(agg, indent=2))
    print(json.dumps(agg))
    return agg


def _golden_band(base_overrides: list[str], mean_f1) -> dict | None:
    """The committed quality band for the protocol's dataset, with a
    verdict only when the protocol matches the band's (epochs, full corpus,
    seed); ``None`` without a band or a mean F1."""
    def last(key: str, default: str) -> str:
        return next((o.split("=", 1)[1] for o in reversed(base_overrides)
                     if o.startswith(f"{key}=")), default)

    dsname = last("data.dsname", "bigvul")
    golden = json.loads((REPO / "configs" / "golden_quality.json")
                        .read_text()).get(dsname)
    if not isinstance(golden, dict) or mean_f1 is None:
        return None
    matches = (last("optim.max_epochs", "") == str(golden["max_epochs"])
               and last("data.sample", "false") == "false"
               and last("seed", "0") == str(golden["train_seed"]))
    return {"dsname": dsname, "min_test_f1": golden["min_test_f1"],
            "protocol_matches": matches,
            "within_band": mean_f1 >= golden["min_test_f1"] if matches
            else None,
            # the corpus's shape is not visible from here
            "unchecked": [f"corpus n={golden['n']} "
                          f"corpus_seed={golden['corpus_seed']}"]}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m deepdfa_tpu_torch.performance_evaluation")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--protocol", choices=("ggnn", "full"),
                        default="ggnn",
                        help="ggnn: timed GGNN fit/test repetitions; full: "
                             "the reference's DeepDFA / LineVul / "
                             "DeepDFA+LineVul stages")
    parser.add_argument("--out", default=None)
    parser.add_argument("--config", action="append", default=[])
    parser.add_argument("--set", action="append", default=[],
                        dest="overrides")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from deepdfa_tpu_torch import resolve_device, utils

    backend = resolve_device(args.device).type
    if args.protocol == "full":
        out_dir = Path(args.out) if args.out else (utils.storage_dir()
                                                   / "perf_eval_full")
        out_dir.mkdir(parents=True, exist_ok=True)
        return full_protocol(args, out_dir)

    out_dir = Path(args.out) if args.out else utils.storage_dir() / "perf_eval"
    out_dir.mkdir(parents=True, exist_ok=True)
    base_overrides = ["data.sample=true", "optim.max_epochs=3",
                      "profile=true", "time=true", *args.overrides]
    common = ([x for c in args.config for x in ("--config", c)]
              + [x for o in base_overrides for x in ("--set", o)])
    runs = []
    for i in range(args.runs):
        run_dir = out_dir / f"run_{i}"
        t0 = time.monotonic()
        _cli(["fit", "--run-dir", str(run_dir), *common], args.device)
        fit_s = time.monotonic() - t0
        t1 = time.monotonic()
        results = _cli(["test", "--run-dir", str(run_dir), *common],
                       args.device)
        runs.append({"run": i, "fit_seconds": round(fit_s, 2),
                     "test_seconds": round(time.monotonic() - t1, 2),
                     "test_F1Score": results.get("test_F1Score"),
                     "profile_examples_per_sec":
                         results.get("profile_examples_per_sec"),
                     "profile_gflops_per_example":
                         results.get("profile_gflops_per_example")})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)

    f1s = [r["test_F1Score"] for r in runs if r["test_F1Score"] is not None]
    agg = {"backend": backend, "runs": runs,
           "mean_fit_seconds": sum(r["fit_seconds"] for r in runs) / len(runs),
           "mean_test_seconds": sum(r["test_seconds"] for r in runs)
           / len(runs),
           # None, not 0.0, when a run gave no F1
           "mean_test_F1Score": (sum(f1s) / len(f1s) if len(f1s) == len(runs)
                                 else None)}
    band = _golden_band(base_overrides, agg["mean_test_F1Score"])
    if band is not None:
        agg["golden_quality"] = band
    (out_dir / "performance_evaluation.json").write_text(
        json.dumps(agg, indent=2))
    print(json.dumps({k: v for k, v in agg.items() if k != "runs"}))
    return agg


if __name__ == "__main__":
    main()
