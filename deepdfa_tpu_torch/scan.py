"""Scan C sources: the streaming end-to-end surface, scoring on the card.

The port of ``deepdfa_tpu/scan.py``. Every C source under the given paths
streams through the work-stealing
:class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool` (encode
sessions from the frontend pool's factory, threads or spawned processes:
C source → CPG → dependence edges → features → ``Graph``) with the
content-addressed :class:`~deepdfa_tpu_torch.data.extract_cache.ExtractCache`
in front; with an ``engine`` the encoded functions are scored through the
port's :class:`~deepdfa_tpu_torch.serve.engine.ScoringEngine`, grouped by
serve bucket (kernel B1, or B5 under ``precision="int8"``). Options:

- ``tier2`` (a :class:`~deepdfa_tpu_torch.llm.joint_engine.JointEngine`)
  rescores the borderline band on the LLM tier (kernel B6);
- ``interproc=True`` merges every scanned file into one CPG, runs the
  cross-function taint differential over its supergraph and scores the
  whole unit through the engine's hierarchical scorer (kernel B4, fronted
  by a function-embedding cache under ``{cache_dir}/emb``).

A re-scan of a mostly-unchanged tree re-encodes only changed files (the
cache key is the whitespace-normalized content hash salted with the
vocabulary hash), an unparseable file is one error row (never a dead
scan). The engines run on the card unless they were built for another
device.

:func:`scan_command` is the command-line entry (``python -m
deepdfa_tpu_torch.scan <dir> --run-dir ... --ckpt-dir ...``): it restores
a ``train.fit`` checkpoint into the fused layout
(:meth:`~deepdfa_tpu_torch.serve.engine.ScoringEngine.from_checkpoint`),
scans and writes ``scan.json`` into the run directory.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Sequence

from deepdfa_tpu_torch.data.extract_cache import ExtractCache
from deepdfa_tpu_torch.data.extraction import ExtractionPool
from deepdfa_tpu_torch.pipeline import vocab_content_hash

__all__ = ["collect_c_files", "main", "scan_command", "scan_paths"]

logger = logging.getLogger("deepdfa_tpu_torch")


def collect_c_files(paths: Sequence[str | Path]) -> list[Path]:
    """Every scannable file under ``paths``: directories recurse over
    ``*.c``; an explicit file path of any extension is honored. Missing
    paths raise."""
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.c")))
        elif p.exists():
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return out


def _session_factory(vocabs, frontend, keep_cpg: bool = False):
    """The scan's encode sessions come from the factory the online
    :class:`~deepdfa_tpu_torch.serve.frontend.FrontendPool` uses, so mode
    (process or thread), the vocabulary-hash spawn handshake and timeouts
    are one implementation. ``"inline"`` (or no ``frontend``) means thread
    sessions: the encode still runs on the pool's workers."""
    from deepdfa_tpu_torch.config import FrontendConfig
    from deepdfa_tpu_torch.serve.frontend import encode_session_factory

    if frontend is None or frontend.mode == "inline":
        frontend = FrontendConfig(mode="thread")
    return encode_session_factory(vocabs, frontend, keep_cpg=keep_cpg)


def _score_functions(engine, rows: list[dict], graphs: list) -> None:
    """Batch ``graphs`` through the engine grouped by serve bucket and
    write ``vulnerable_probability`` back onto the paired rows."""
    by_bucket: dict = {}
    for row, g in zip(rows, graphs):
        try:
            bucket = engine.assign_bucket(g)
        except Exception as exc:  # noqa: BLE001 — oversize = error row
            row["error"] = f"{type(exc).__name__}: {exc}"
            continue
        by_bucket.setdefault(bucket, []).append((row, g))
    for bucket, pairs in by_bucket.items():
        cap = max(int(bucket.capacity), 1)
        for start in range(0, len(pairs), cap):
            chunk = pairs[start:start + cap]
            probs = engine.score([g for _, g in chunk], bucket)
            for (row, _), p in zip(chunk, probs):
                row["vulnerable_probability"] = round(float(p), 6)


def _cascade_rescore(tier2, band, rows: list[dict], graphs: list,
                     source_by_file: dict[str, str]) -> None:
    """Offline mirror of the serving cascade: every scored row records the
    answering ``tier`` and its ``tier1_score``; rows inside the borderline
    band rescore through the tier-2 joint engine, fed the owning file's
    source text. A tier-2 failure keeps the tier-1 score and marks the
    borderline rows ``tier2_degraded`` — the scan never aborts on it."""
    lo, hi = band
    scored = [(row, g) for row, g in zip(rows, graphs)
              if "vulnerable_probability" in row]
    for row, _ in scored:
        row["tier"] = 1
        row["tier1_score"] = row["vulnerable_probability"]
    borderline = [(row, g) for row, g in scored
                  if lo <= row["vulnerable_probability"] <= hi]
    if not borderline:
        return
    items = [(source_by_file.get(row["file"], ""), g)
             for row, g in borderline]
    try:
        probs = tier2.score(items)
    except Exception as exc:  # noqa: BLE001 — degrade, never abort the scan
        logger.warning("scan cascade: tier-2 rescore failed (%s: %s) — "
                       "keeping tier-1 scores", type(exc).__name__, exc)
        for row, _ in borderline:
            row["tier2_degraded"] = True
        return
    for (row, _), p in zip(borderline, probs):
        row["tier"] = 2
        row["vulnerable_probability"] = round(float(p), 6)


def _interproc_pass(sources: list[tuple[str, str]],
                    parsed: dict[str, list] | None = None):
    """Whole-unit interprocedural pass over the scanned sources: merge the
    per-file CPGs into one graph (so calls resolve across files), build the
    call-graph supergraph and run the cross-function taint differential.
    Findings are the taint flows a per-function scan cannot see.

    ``parsed`` maps a file name to its already-parsed per-function CPGs
    (the scan's encode sessions keep them); other files (warm cache
    entries, parse failures) are parsed again. Per-file failures are error
    rows; this never aborts the scan. Returns ``(report,
    supergraph-or-None)``."""
    from deepdfa_tpu_torch.cpg.frontend import parse_source
    from deepdfa_tpu_torch.cpg.interproc import (build_supergraph,
                                                 cross_function_taint,
                                                 merge_cpgs)

    parsed = parsed or {}
    cpgs, errors = [], []
    n_files, n_reused = 0, 0
    for name, code in sources:
        pre = parsed.get(name)
        if pre:
            cpgs.extend(pre)
            n_files += 1
            n_reused += 1
            continue
        try:
            cpgs.append(parse_source(code))
            n_files += 1
        except Exception as exc:  # noqa: BLE001 — one error row per file
            errors.append({"file": name, "error": f"{type(exc).__name__}: {exc}"})
    base = {"n_files_parsed": n_files, "n_files_reused": n_reused,
            "errors": errors, "findings": [], "attribution": {},
            "call_edges": 0, "functions": 0}
    if not cpgs:
        return base, None
    merged, _ = merge_cpgs(cpgs)
    try:
        sg = build_supergraph(merged)
        cross = cross_function_taint(sg)
    except Exception as exc:  # noqa: BLE001 — degrade, never abort
        logger.warning("scan interproc: supergraph pass failed (%s: %s)",
                       type(exc).__name__, exc)
        errors.append({"file": "<merged>",
                       "error": f"{type(exc).__name__}: {exc}"})
        return base, None
    base.update(
        findings=cross["findings"],
        attribution=cross["attribution"],
        call_edges=sg.n_call_edges,
        functions=len(sg.callgraph.methods),
    )
    return base, sg


def _function_source(file_source: str, cpg) -> str | None:
    """The line-slice of ``file_source`` covering one function's CPG — the
    content the embedding cache keys on, so a sibling-function edit does not
    invalidate every entry of the file. None for a CPG without lines."""
    lines = [n.line for n in cpg.nodes.values()
             if getattr(n, "line", None)]
    if not lines:
        return None
    lo, hi = min(lines), max(lines)
    split = file_source.split("\n")
    return "\n".join(split[max(lo - 1, 0):hi])


def _attach_embedding_cache(engine, vocabs, cache_dir) -> None:
    """Front the engine's hierarchical scorer with a function-embedding
    cache under ``{cache_dir}/emb``, keyed on the function source × model
    revision × vocabulary × feature keys, so a warm rescan of unchanged
    functions makes no level-1 dispatch. No cache dir, or a scorer that
    already has a cache, is a no-op."""
    if cache_dir is None:
        return
    try:
        hier = engine.hier
        if hier.cache is not None:
            return
        from deepdfa_tpu_torch.serve.embcache import FunctionEmbeddingCache
        hier.cache = FunctionEmbeddingCache(
            Path(cache_dir) / "emb",
            model_rev=getattr(engine, "model_rev", "unknown") or "unknown",
            vocab_hash=vocab_content_hash(vocabs),
            feature_salt=",".join(getattr(engine, "feat_keys", ()) or ()),
            dim=hier.out_dim,
        )
    except Exception as exc:  # noqa: BLE001 — the cache is an optimisation
        logger.warning("scan interproc: embedding cache unavailable "
                       "(%s: %s)", type(exc).__name__, exc)


def _score_unit(engine, sg, unit_fns: list) -> dict:
    """One hierarchical ``score_unit`` request over the merged unit. Any
    failure degrades to a ``unit_error`` entry; the scan never aborts."""
    try:
        return engine.score_unit(unit_fns, sg)
    except Exception as exc:  # noqa: BLE001 — degrade, never abort
        logger.warning("scan interproc: unit scoring failed (%s: %s)",
                       type(exc).__name__, exc)
        return {"unit_error": f"{type(exc).__name__}: {exc}"}


def scan_paths(
    paths: Sequence[str | Path],
    vocabs,
    *,
    engine=None,
    tier2=None,
    tier2_band: tuple[float, float] = (0.35, 0.65),
    n_workers: int = 4,
    cache_dir: str | Path | None = None,
    attempts_per_item: int = 2,
    frontend=None,
    interproc: bool = False,
) -> dict:
    """Scan ``paths``; returns the report dict: the JAX package's keys, plus
    ``score_s`` (host seconds of the tier-1 scoring). Per-file failures are
    error rows; nothing aborts the scan. The encode runs on ``n_workers``
    sessions of ``frontend``'s mode (a :class:`~deepdfa_tpu_torch.config.
    FrontendConfig`; thread sessions by default, spawned children with
    ``mode="process"`` — those return no CPGs, so the interprocedural pass
    parses their files again)."""
    from deepdfa_tpu_torch.models.ggnn_hier import UnitFunction

    files = collect_c_files(paths)
    sources: list[tuple[str, str]] = [
        (str(f), f.read_text(errors="replace")) for f in files]
    cache = None
    if cache_dir is not None:
        # salted with the vocabulary content: encoding is vocab-dependent,
        # so a re-vocabed corpus misses rather than serving stale encodings
        cache = ExtractCache(cache_dir, salt=vocab_content_hash(vocabs))
    pool = ExtractionPool(
        _session_factory(vocabs, frontend, keep_cpg=interproc),
        n_workers=max(1, min(n_workers, max(len(sources), 1))),
        attempts_per_item=attempts_per_item,
        cache=cache,
        cache_code=lambda code: code,
    )
    t0 = time.perf_counter()
    results = pool.run(
        [(name, code) for name, code in sources],
        lambda session, code: session.encode(code),
    )
    elapsed = time.perf_counter() - t0

    source_by_file = dict(sources)
    rows: list[dict] = []
    score_rows: list[dict] = []
    score_graphs: list = []
    parsed_cpgs: dict[str, list] = {}
    unit_fns: list = []
    for res in results:
        if res.error is not None:
            rows.append({"file": res.key, "error": res.error,
                         "quarantined": res.quarantined})
            continue
        if interproc and res.value and all(
                fn.cpg is not None for fn in res.value):
            # thread-mode encode kept the per-function CPGs: the interproc
            # pass reuses them; process-mode results and cache entries
            # written without them re-parse
            parsed_cpgs[res.key] = [fn.cpg for fn in res.value]
        for fn in res.value:
            row = {"file": res.key, "function": fn.name,
                   "cache_hit": res.cache_hit}
            if fn.graph is None:
                row["error"] = fn.error
            else:
                if engine is not None:
                    score_rows.append(row)
                    score_graphs.append(fn.graph)
                if interproc:
                    file_code = source_by_file.get(res.key, "")
                    code = (_function_source(file_code, fn.cpg)
                            if fn.cpg is not None else None)
                    unit_fns.append(UnitFunction(
                        fn.name, code or f"{fn.name}\n{file_code}", fn.graph))
            rows.append(row)
    score_s = 0.0
    if engine is not None and score_graphs:
        t1 = time.perf_counter()
        _score_functions(engine, score_rows, score_graphs)
        score_s = time.perf_counter() - t1
        if tier2 is not None:
            _cascade_rescore(tier2, tier2_band, score_rows, score_graphs,
                             source_by_file)

    n_err = sum(1 for r in rows if "error" in r)
    report = {
        "results": rows,
        "n_files": len(sources),
        "n_functions": len(rows) - sum(1 for r in rows if "function" not in r),
        "n_scored": sum(1 for r in rows if "vulnerable_probability" in r),
        "n_errors": n_err,
        "elapsed_s": round(elapsed, 3),
        "score_s": round(score_s, 3),
        "pool": pool.report(),
        "cache": cache.stats() if cache is not None else None,
    }
    if interproc:
        ip_report, sg = _interproc_pass(sources, parsed_cpgs)
        report["interproc"] = ip_report
        if engine is not None and sg is not None and unit_fns:
            _attach_embedding_cache(engine, vocabs, cache_dir)
            ip_report["unit"] = _score_unit(engine, sg, unit_fns)
    if tier2 is not None:
        report["cascade"] = {
            "band": [float(tier2_band[0]), float(tier2_band[1])],
            "n_tier2": sum(1 for r in rows if r.get("tier") == 2),
            "n_degraded": sum(1 for r in rows if r.get("tier2_degraded")),
            "tier2_model_rev": getattr(tier2, "model_rev", "unknown"),
        }
    logger.info(
        "scan: %d file(s) → %d function(s), %d scored, %d error row(s) "
        "in %.2fs (cache %s)", report["n_files"], report["n_functions"],
        report["n_scored"], n_err, elapsed,
        f"hit_rate={report['cache']['hit_rate']:.2f}" if cache else "off",
    )
    return report


def scan_command(cfg, run_dir: Path, targets: Sequence[str], *,
                 ckpt_dir: Path | None = None, artifact: str | None = None,
                 workers: int = 4, cache_dir: Path | None = None,
                 cascade: bool = False, interproc: bool = False,
                 shard_dir: Path | None = None, device=None) -> dict:
    """The CLI entry: vocabularies from ``shard_dir`` (default: the
    config's processed dataset dir), a scoring engine restored from
    ``ckpt_dir`` when one is given (the scan still encodes without one),
    tier 2 restored from ``serve.cascade.joint_dir`` with ``cascade``;
    ``scan.json`` written atomically into ``run_dir``. ``artifact`` (an
    exported artifact directory) scores instead of a checkpoint. The
    engines run on ``device`` (``cuda`` unless the caller names another)."""
    from deepdfa_tpu_torch import utils
    from deepdfa_tpu_torch.pipeline import load_vocabs
    from deepdfa_tpu_torch.resilience.journal import atomic_write_text

    ccfg = cfg.serve.cascade
    if cascade:
        # fail fast, before shard/vocab resolution touches the filesystem
        if artifact is None and ckpt_dir is None:
            raise ValueError(
                "scan --cascade needs tier-1 scores: pass --ckpt-dir or "
                "--artifact")
        if ccfg.joint_dir is None:
            raise ValueError(
                "scan --cascade needs a tier-2 checkpoint: set "
                "serve.cascade.joint_dir (a JointTrainer run dir)")
    if shard_dir is None:
        sample_text = "_sample" if cfg.data.sample else ""
        shard_dir = (utils.processed_dir() / cfg.data.dsname
                     / f"shards{sample_text}")
    vocabs = load_vocabs(shard_dir)

    engine = None
    if artifact is not None:
        from deepdfa_tpu_torch.serve.engine import ScoringEngine

        engine = ScoringEngine.from_artifact(artifact, vocabs=vocabs,
                                             device=device)
    elif ckpt_dir is not None:
        from deepdfa_tpu_torch.serve.engine import ScoringEngine

        engine = ScoringEngine.from_checkpoint(cfg, ckpt_dir, vocabs,
                                               device=device)
    else:
        logger.info("scan: no --ckpt-dir/--artifact — encoding without "
                    "scores")

    tier2 = None
    if cascade:
        from deepdfa_tpu_torch.llm.joint_engine import JointEngine

        tier2 = JointEngine.from_run_dir(
            ccfg.joint_dir, max_batch=ccfg.tier2_max_batch, device=device)

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    report = scan_paths(
        targets, vocabs, engine=engine, tier2=tier2,
        tier2_band=(ccfg.band_lo, ccfg.band_hi), n_workers=workers,
        cache_dir=cache_dir if cache_dir is not None
        else run_dir / "extract_cache",
        frontend=cfg.serve.frontend, interproc=interproc)
    atomic_write_text(run_dir / "scan.json", json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items() if k != "results"},
                     sort_keys=True), flush=True)
    return report


def main(argv=None) -> dict:
    """``python -m deepdfa_tpu_torch.scan <target> ...``: the scan rows of
    the JAX package's ``deepdfa-tpu scan`` (a positional target and/or
    ``--source``, ``--config``/``--set``, ``--run-dir``, ``--ckpt-dir``,
    ``--workers``, ``--cache-dir``, ``--artifact``, ``--cascade``,
    ``--interproc``), plus ``--shard-dir`` and ``--device``. A run dir's
    ``config.json``, when it has one, is the base config layer."""
    import argparse

    from deepdfa_tpu_torch import utils
    from deepdfa_tpu_torch.config import load_config
    from deepdfa_tpu_torch.serve.server import parse_overrides

    parser = argparse.ArgumentParser(prog="deepdfa-tpu-torch-scan")
    parser.add_argument("target", nargs="?", default=None,
                        help="the repo/dir/file to walk (or use --source)")
    parser.add_argument("--source", action="append", default=[],
                        help="C file or directory (repeatable)")
    parser.add_argument("--config", action="append", default=[],
                        help="layered config files (later files win)")
    parser.add_argument("--set", action="append", default=[], dest="overrides",
                        help="dotted overrides, e.g. --set serve.max_batch=32")
    parser.add_argument("--run-dir", default=None,
                        help="where scan.json goes (default: a new "
                             "<storage>/runs/scan-<time> dir)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="checkpoint dir of a fit run (scores the scan)")
    parser.add_argument("--workers", type=int, default=4,
                        help="extraction-pool worker count")
    parser.add_argument("--cache-dir", default=None,
                        help="extraction-cache dir (default: "
                             "<run-dir>/extract_cache)")
    parser.add_argument("--artifact", default=None,
                        help="exported artifact dir (python -m "
                             "deepdfa_tpu_torch.train.cli export) instead "
                             "of a checkpoint")
    parser.add_argument("--cascade", action="store_true",
                        help="rescore borderline-band functions through the "
                             "tier-2 joint engine (needs "
                             "serve.cascade.joint_dir)")
    parser.add_argument("--interproc", action="store_true",
                        help="also score the target as one unit: merged "
                             "CPGs, the call-graph supergraph, cross-"
                             "function taint flows and the hierarchical "
                             "unit score in scan.json['interproc']")
    parser.add_argument("--shard-dir", default=None,
                        help="shard dir holding vocab.json (default: the "
                             "config's processed dataset dir)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    targets = ([args.target] if args.target else []) + list(args.source)
    if not targets:
        parser.error("scan requires a target path (positional or --source)")

    layers = list(args.config)
    if args.run_dir and (Path(args.run_dir) / "config.json").exists():
        layers.insert(0, Path(args.run_dir) / "config.json")
    cfg = load_config(*layers, overrides=parse_overrides(args.overrides))
    run_dir = (Path(args.run_dir) if args.run_dir else utils.get_dir(
        utils.storage_dir() / "runs" / time.strftime("scan-%Y%m%d-%H%M%S")))
    logging.basicConfig(level=logging.INFO)
    return scan_command(
        cfg, run_dir, targets,
        ckpt_dir=Path(args.ckpt_dir) if args.ckpt_dir else None,
        artifact=args.artifact, workers=args.workers,
        cache_dir=Path(args.cache_dir) if args.cache_dir else None,
        cascade=args.cascade, interproc=args.interproc,
        shard_dir=Path(args.shard_dir) if args.shard_dir else None,
        device=args.device)


if __name__ == "__main__":
    main()
