"""Perf-regression ledger: rolling-baseline verdicts over bench history.

A copy of ``deepdfa_tpu/obs/ledger.py`` (standard library only). Where
:mod:`deepdfa_tpu_torch.obs.drift` judges score *distributions* against a
frozen reference, the ledger judges bench *numbers* against a rolling
baseline.

Normalization: every artifact shape the repo's ``BENCH_*.json`` /
``MULTICHIP_*.json`` files have ever had is ingested without crashing:
the ``{n, cmd, rc, tail, parsed}`` runner wrapper (``parsed`` may be
null), bare stage artifacts, and the multichip smoke shape ``{n_devices,
rc, ok, ...}``. Numeric leaves become :class:`LedgerEntry` rows keyed by
``(stage, metric, git_rev, device_kind)``; artifacts that carry
``schema_version`` and older ones are recognized structurally.

Verdicts: per ``(stage, metric, device_kind)`` series, the latest entry is
judged against the median of the previous K entries with a MAD band
(3·1.4826·MAD, floored by a relative tolerance so flat series still have a
band). Device kinds never mix. A series shorter than ``min_history + 1``
gets ``no_baseline`` (never red).

Command line (also ``python -m deepdfa_tpu_torch.train.cli bench
ledger``)::

    python -m deepdfa_tpu_torch.obs.ledger --check [paths...]   # rc 1 on regression
    python -m deepdfa_tpu_torch.obs.ledger --trend [paths...]   # per-series trends

``--store ledger.jsonl`` appends normalized rows to an append-only history
file (new sources only) and judges the union.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict, dataclass
from pathlib import Path
from statistics import median

__all__ = [
    "EXPLICIT_SERIES",
    "LedgerEntry",
    "Ledger",
    "LedgerStore",
    "iter_entries",
    "lower_is_better",
    "main",
]

SCHEMA_VERSION = 1  # first explicitly-versioned artifact generation

# artifact files the repo commits at its root
ARTIFACT_GLOBS = ("BENCH*.json", "MULTICHIP*.json")

# provenance / runner bookkeeping — never perf metrics
_SKIP_KEYS = {
    "git_rev", "git_dirty", "emitted_at_unix", "schema_version",
    "n", "cmd", "rc", "tail", "seed", "argv", "backend", "device_kind",
    "stage", "metric", "unit", "precision", "label_style",
}

_MAX_DEPTH = 2  # top-level scalars + one nested stage block

# metric-name tokens where smaller is the good direction
_LOWER_TOKENS = ("latency", "wait", "overhead", "seconds", "wall",
                 "dropped", "errors", "delta", "psi")
_LOWER_SUFFIXES = ("_ms", "_s", "_us")

# Series whose direction is DECLARED rather than inferred. The name
# heuristic already gets these right today, but the megabatch stage's
# headline metrics are load-bearing gates (the whole-model-fusion PR is
# judged on them), so their direction must not silently flip if the
# token lists above ever grow a colliding substring. (stage, metric) →
# lower_is_better.
EXPLICIT_SERIES: dict[tuple[str, str], bool] = {
    ("ggnn_megabatch", "mfu"): False,
    ("ggnn_megabatch", "mfu_nominal"): False,
    ("ggnn_megabatch", "graphs_per_sec"): False,
    ("ggnn_megabatch", "packing_efficiency"): False,
    ("ggnn_megabatch", "dispatches_per_step"): True,
    # the autoscale bench block (scripts/bench_serving.py --autoscale):
    # all four are lower-is-better — fast replacement, little SLO burn,
    # a calm decision loop (flap shows up as extra decisions), and the
    # invariant-11 join metric where any nonzero value is a regression
    ("autoscale", "replace_latency_s"): True,
    ("autoscale", "slo_burn_minutes"): True,
    ("autoscale", "scale_decisions"): True,
    ("autoscale", "join_cold_compiles"): True,
    # the extraction stage (scripts/bench_extraction.py --pool): pool
    # throughput and the warm-re-scan hit rate go up; "quarantined" is a
    # count whose name trips neither heuristic token list (it would read
    # as higher-is-better), so its direction must be declared.
    ("extraction", "functions_per_sec"): False,
    ("extraction", "cache_hit_rate"): False,
    ("extraction", "quarantined"): True,
    # the cascade bench block (scripts/bench_serving.py --cascade):
    # tier-2 tail latency and the invariant-24 degraded counter go down
    # (any nonzero degraded under nominal load is a regression);
    # "escalated_frac" is a band-mass CONFORMANCE metric — drifting UP
    # means the band leaks confident traffic to the expensive tier, so
    # lower is the safe gate direction (the ±tolerance gate in
    # bench.assemble_cascade_result owns the two-sided check).
    ("cascade", "tier2_p99_ms"): True,
    ("cascade", "degraded_total"): True,
    ("cascade", "escalated_frac"): True,
    # the frontend bench block (scripts/bench_serving.py --frontend):
    # encode latency and queue wait go down; "overlap_frac" — the
    # fraction of pool encode time that overlapped a device dispatch —
    # is the whole point of taking encode off the GIL-bound handler
    # thread, so it goes up (and its name trips no heuristic token).
    ("frontend", "encode_p50_ms"): True,
    ("frontend", "encode_p99_ms"): True,
    ("frontend", "queue_wait_ms"): True,
    ("frontend", "overlap_frac"): False,
    # the interproc stage (scripts/bench_extraction.py --interproc):
    # supergraph construction and the per-backend interprocedural taint
    # solves go down; corpus throughput through the whole pipeline
    # (build + solve) goes up. "_ms" suffixes would trip the heuristic
    # anyway — declared so the directions are contractual, not inferred.
    ("interproc", "supergraph_build_ms"): True,
    ("interproc", "solve_sets_ms"): True,
    ("interproc", "solve_bitvec_ms"): True,
    ("interproc", "solve_native_ms"): True,
    ("interproc", "functions_per_sec"): False,
    # the hierarchical stage (scripts/bench_hier.py): whole-unit scoring
    # latency and the warm-rescan level-1 recompute count go down (any
    # nonzero warm recompute means the embedding cache leaked a miss);
    # "fallback_dispatches" is the never-falls-off-the-fused-kernels
    # gate — any nonzero value is a regression. Cache hit rate and the
    # cold-vs-warm speedup go up; neither name trips the heuristic.
    ("hier", "unit_score_ms"): True,
    ("hier", "level1_recompute"): True,
    ("hier", "fallback_dispatches"): True,
    ("hier", "embed_cache_hit_rate"): False,
    ("hier", "warm_speedup"): False,
    # the admission bench block (scripts/bench_serving.py --overload):
    # overload COST and contract violations all go down — SLO burn
    # minutes paged during the sawtooth, 5xx leaked to the interactive
    # class, sheds under nominal load, interactive sheds before the
    # brownout ladder reached its last level, and 429s missing their
    # Retry-After header (each nonzero violation is a regression of
    # invariant candidate 30). Overload shed counts are the mechanism
    # WORKING, not a quality signal — deliberately untracked here.
    ("admission", "slo_burn_minutes"): True,
    ("admission", "interactive_5xx_total"): True,
    ("admission", "responses_5xx_total"): True,
    ("admission", "nominal_shed_total"): True,
    ("admission", "interactive_sheds_before_brownout"): True,
    ("admission", "retry_after_missing"): True,
    ("admission", "journal_drops"): True,
    # the promotion stage (scripts/bench_promotion.py): the roll's
    # wall-clock goes down; "rollback_total" counts rolls the drift
    # watch reverted (the bench forces exactly one, so growth means the
    # forward leg started failing too); "join_cold_compiles" is the
    # invariant-11 warm-join gate — any nonzero value is a regression.
    ("promotion", "rollout_seconds"): True,
    ("promotion", "rollback_total"): True,
    ("promotion", "join_cold_compiles"): True,
    # the federation block (scripts/bench_serving.py --federation): a
    # killed cell's heal-and-rejoin wall-clock goes down, and both
    # violation counts — spilled forwards lost instead of retried, and
    # 5xx leaked to clients while a cell was dead — are regressions of
    # invariant candidate 32 at any nonzero value. Spillover VOLUME is
    # the mechanism working, not a quality signal — untracked.
    ("federation", "cell_kill_recovery_s"): True,
    ("federation", "spillover_errors"): True,
    ("federation", "fleetwide_5xx"): True,
}


def lower_is_better(metric: str, stage: str | None = None) -> bool:
    if stage is not None and (stage, metric) in EXPLICIT_SERIES:
        return EXPLICIT_SERIES[(stage, metric)]
    m = metric.lower()
    return m.endswith(_LOWER_SUFFIXES) or any(t in m for t in _LOWER_TOKENS)


@dataclass(frozen=True)
class LedgerEntry:
    """One normalized observation: a number some bench run measured."""

    stage: str
    metric: str
    value: float
    device_kind: str
    git_rev: str
    emitted_at: int
    source: str


def _numeric(v) -> float | None:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _walk(doc: dict, stage: str, depth: int, emit) -> None:
    for key, val in doc.items():
        if not isinstance(key, str) or key in _SKIP_KEYS:
            continue
        if isinstance(val, bool):
            if key == "ok":  # pass/fail gates are 0/1 series
                emit(stage, key, float(val))
            continue
        num = _numeric(val)
        if num is not None:
            emit(stage, key, num)
        elif isinstance(val, dict) and depth < _MAX_DEPTH:
            _walk(val, key if stage == "headline" else f"{stage}.{key}",
                  depth + 1, emit)


def iter_entries(doc, source: str = "<mem>") -> list[LedgerEntry]:
    """Normalize one artifact document into ledger rows. Tolerates every
    historical shape; anything unrecognizable yields zero rows rather
    than an exception (an unreadable artifact must not kill the gate)."""
    if not isinstance(doc, dict):
        return []
    # runner wrapper {n, cmd, rc, tail, parsed} — r01..r05; parsed may be
    # null (r05: the run died before emitting an artifact)
    if "parsed" in doc and "cmd" in doc:
        parsed = doc.get("parsed")
        if not isinstance(parsed, dict):
            return []
        doc = parsed
    # multichip smoke shape: the gate metric is the boolean verdict
    if "n_devices" in doc and "ok" in doc:
        return [LedgerEntry(
            stage="multichip", metric="ok", value=float(bool(doc["ok"])),
            device_kind=str(doc.get("device_kind") or "unknown"),
            git_rev=str(doc.get("git_rev") or "unknown"),
            emitted_at=int(doc.get("emitted_at_unix") or 0),
            source=source)]
    device = str(doc.get("device_kind") or doc.get("backend") or "unknown")
    rev = str(doc.get("git_rev") or "unknown")
    emitted = int(doc.get("emitted_at_unix") or 0)
    # the assembler shape names its headline: {"metric": "<name>",
    # "value": <n>}. Keying the series by the declared name instead of the
    # literal "value" keeps incommensurate headlines apart — a train
    # bench's graphs/sec and a serve bench's req/s must never share one
    # rolling baseline just because both spell their number "value".
    headline_name = doc.get("metric")
    out: list[LedgerEntry] = []

    def emit(stage: str, metric: str, value: float) -> None:
        if (stage == "headline" and metric == "value"
                and isinstance(headline_name, str) and headline_name):
            metric = headline_name
        out.append(LedgerEntry(stage=stage, metric=metric, value=value,
                               device_kind=device, git_rev=rev,
                               emitted_at=emitted, source=source))

    _walk(doc, "headline", 0, emit)
    return out


# ---------------------------------------------------------------------------
# the append-only history store


class LedgerStore:
    """Append-only JSONL of normalized rows. ``ingest`` backfills: rows
    from sources already present are skipped, so re-running against the
    committed history is idempotent."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self) -> list[LedgerEntry]:
        if not self.path.exists():
            return []
        rows = []
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                rows.append(LedgerEntry(
                    stage=rec["stage"], metric=rec["metric"],
                    value=float(rec["value"]),
                    device_kind=rec["device_kind"], git_rev=rec["git_rev"],
                    emitted_at=int(rec["emitted_at"]), source=rec["source"]))
            except (ValueError, KeyError, TypeError):
                continue  # a torn append-tail must not kill the gate
        return rows

    def ingest(self, entries) -> int:
        known = {e.source for e in self.load()}
        fresh = [e for e in entries if e.source not in known]
        if fresh:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self.path.open("a", encoding="utf-8") as fh:
                for e in fresh:
                    fh.write(json.dumps({"schema": SCHEMA_VERSION,
                                         **asdict(e)}) + "\n")
                fh.flush()
        return len(fresh)


# ---------------------------------------------------------------------------
# verdicts


class Ledger:
    """Entries + the rolling-baseline verdict engine."""

    def __init__(self, entries=()):
        self.entries: list[LedgerEntry] = list(entries)

    # -- ingestion ----------------------------------------------------------

    def ingest(self, doc, source: str = "<mem>") -> int:
        rows = iter_entries(doc, source)
        self.entries.extend(rows)
        return len(rows)

    def ingest_path(self, path) -> int:
        path = Path(path)
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            return 0  # unreadable artifact ≠ gate crash
        return self.ingest(doc, source=path.name)

    @classmethod
    def from_paths(cls, paths) -> "Ledger":
        led = cls()
        for p in discover_artifacts(paths):
            led.ingest_path(p)
        return led

    # -- series + verdicts --------------------------------------------------

    def series(self) -> dict[tuple[str, str, str], list[LedgerEntry]]:
        by_key: dict[tuple[str, str, str], list[LedgerEntry]] = {}
        for e in self.entries:
            by_key.setdefault((e.stage, e.metric, e.device_kind),
                              []).append(e)
        for rows in by_key.values():
            rows.sort(key=lambda e: (e.emitted_at, e.source))
        return by_key

    def verdicts(self, *, k: int = 5, rel_tol: float = 0.15,
                 min_history: int = 3) -> list[dict]:
        """One verdict per series, judging its LATEST entry. ``rel_tol``
        floors the MAD band so a flat baseline still tolerates noise —
        but stays below 0.20, so a 20% regression always trips."""
        out = []
        for (stage, metric, device), rows in sorted(self.series().items()):
            latest = rows[-1]
            prior = [e.value for e in rows[:-1]][-k:]
            row = {
                "stage": stage, "metric": metric, "device_kind": device,
                "value": latest.value, "git_rev": latest.git_rev,
                "source": latest.source, "n_history": len(prior),
                "lower_is_better": lower_is_better(metric, stage),
            }
            if len(prior) < min_history:
                row.update(verdict="no_baseline", baseline=None, band=None)
                out.append(row)
                continue
            base = median(prior)
            mad = median(abs(v - base) for v in prior)
            band = max(3.0 * 1.4826 * mad, rel_tol * abs(base))
            delta = latest.value - base
            if row["lower_is_better"]:
                verdict = ("regression" if delta > band
                           else "improved" if delta < -band else "ok")
            else:
                verdict = ("regression" if delta < -band
                           else "improved" if delta > band else "ok")
            row.update(verdict=verdict, baseline=round(base, 6),
                       band=round(band, 6))
            out.append(row)
        return out

    def check(self, **kw) -> tuple[bool, list[dict]]:
        rows = self.verdicts(**kw)
        return all(r["verdict"] != "regression" for r in rows), rows

    # -- trend rendering ----------------------------------------------------

    _SPARK = "▁▂▃▄▅▆▇█"

    @classmethod
    def _sparkline(cls, values) -> str:
        lo, hi = min(values), max(values)
        if hi <= lo:
            return cls._SPARK[3] * len(values)
        steps = len(cls._SPARK) - 1
        return "".join(
            cls._SPARK[round((v - lo) / (hi - lo) * steps)] for v in values)

    def trend_lines(self, **kw) -> list[str]:
        verdict_by_key = {(r["stage"], r["metric"], r["device_kind"]): r
                          for r in self.verdicts(**kw)}
        lines = []
        for key, rows in sorted(self.series().items()):
            stage, metric, device = key
            vals = [e.value for e in rows]
            v = verdict_by_key[key]
            tail = v["verdict"]
            if v["baseline"] is not None and v["baseline"] != 0:
                pct = 100.0 * (vals[-1] - v["baseline"]) / abs(v["baseline"])
                tail += f" ({pct:+.1f}% vs median)"
            lines.append(
                f"{stage}.{metric} [{device}] {self._sparkline(vals)} "
                f"n={len(vals)} latest={vals[-1]:g} {tail}")
        return lines


# ---------------------------------------------------------------------------
# CLI


def discover_artifacts(paths) -> list[Path]:
    """Files are taken as-is; directories are globbed for the committed
    artifact names (non-recursive — the repo keeps them at its root)."""
    found: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for pattern in ARTIFACT_GLOBS:
                found.extend(sorted(p.glob(pattern)))
        elif p.exists():
            found.append(p)
    # de-dup while preserving order (a file named twice is one source)
    seen: set[Path] = set()
    uniq = []
    for p in found:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="deepdfa-tpu-torch bench ledger",
        description="perf-regression verdicts over committed bench history")
    parser.add_argument("paths", nargs="*", default=None,
                        help="artifact files or directories to ingest "
                        "(default: current directory)")
    parser.add_argument("--check", action="store_true",
                        help="exit non-zero if any gated series regressed")
    parser.add_argument("--trend", action="store_true",
                        help="render per-stage trajectories")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit verdict rows as JSON")
    parser.add_argument("--store", default=None,
                        help="append-only JSONL history store; fresh "
                        "sources are backfilled into it")
    parser.add_argument("--k", type=int, default=5,
                        help="baseline = median of last K prior entries")
    parser.add_argument("--rel-tol", type=float, default=0.15,
                        help="relative band floor (must stay < 0.20 so a "
                        "20%% regression always trips)")
    parser.add_argument("--min-history", type=int, default=3,
                        help="prior entries required before a series can "
                        "go red")
    args = parser.parse_args(argv)

    ledger = Ledger.from_paths(args.paths or ["."])
    if args.store:
        store = LedgerStore(args.store)
        added = store.ingest(ledger.entries)
        ledger = Ledger(store.load())
        print(f"ledger: store {args.store}: +{added} rows "
              f"({len(ledger.entries)} total)")
    kw = dict(k=args.k, rel_tol=args.rel_tol, min_history=args.min_history)
    ok, rows = ledger.check(**kw)

    if args.as_json:
        print(json.dumps(rows, indent=2))
    elif args.trend:
        for line in ledger.trend_lines(**kw):
            print(line)
    else:
        judged = [r for r in rows if r["verdict"] != "no_baseline"]
        bad = [r for r in rows if r["verdict"] == "regression"]
        print(f"ledger: {len(ledger.entries)} entries, {len(rows)} series, "
              f"{len(judged)} with baselines, {len(bad)} regressed")
        for r in bad:
            print(f"  REGRESSION {r['stage']}.{r['metric']} "
                  f"[{r['device_kind']}] {r['value']:g} vs baseline "
                  f"{r['baseline']:g} ± {r['band']:g}")
    if args.check and not ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
