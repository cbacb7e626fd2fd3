"""Offline preprocessing: a C corpus → training-ready graph shards.

``python -m deepdfa_tpu_torch.preprocess --dataset bigvul --split fixed``

The port of ``scripts/preprocess.py``. Stages:

1. **ingest** — the generated corpora (``demo``, ``demo_hard``,
   ``demo_order{L}``: :func:`~deepdfa_tpu_torch.data.codegen.demo_corpus`)
   or a real dataset through :func:`~deepdfa_tpu_torch.data.ingest.ds`:
   ``bigvul`` (``external/MSR_data_cleaned.csv``), ``devign``
   (``external/function.json``, graph-level labels), ``diversevul``
   (``external/diversevul.json``) and ``mutated_<name>``
   (``external/mutated/c_<name>.jsonl`` over Big-Vul), ``--sample`` for the
   sample files.
2. **extract** — the C front end and the dependence-edge pass per
   function (``--frontend native``), or Joern (``--frontend joern``: each
   function written to ``processed/{ds}/before/{id}_{digest}.c``, exported
   by a :class:`~deepdfa_tpu_torch.cpg.joern_session.JoernSession` per
   worker through ``cpg/queries/export_func_graph.sc`` and read back with
   :func:`~deepdfa_tpu_torch.cpg.joern.load_cpg`), through the
   work-stealing :class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool`
   (``--workers N`` thread sessions) with the content-addressed
   :class:`~deepdfa_tpu_torch.data.extract_cache.ExtractCache` in front and
   per-shard progress journaled to ``build_journal.json``: a killed build
   resumes at the first unjournaled shard. Failures land in
   ``failed_frontend.txt``; quarantined functions in ``quarantine.json``.
3. **validate** (``--validate``) — graphs with structural errors dropped.
4. **label** — vulnerable lines = removed ∪ dependent-added, through the
   corpus-wide ``statement_labels*.pkl`` cache (the after-patch versions
   go through a supervised Joern session on the Joern path, closed after
   labelling); Devign's graph labels are its ``vul`` column.
5. **split** — seeded random 70/10/20, the dataset's fixed protocol split
   (``--split fixed``: LineVul for Big-Vul and the mutated sets,
   CodeXGLUE for Devign), or a named split file
   (``external/splits/<name>.csv``).
6. **materialize** — :class:`~deepdfa_tpu_torch.data.materialize.
   CorpusBuilder`: train-split vocabularies, encoded graphs, ``.npz``
   shards + ``manifest.json``, ``splits.json``, ``split.txt``,
   ``vocab.json`` and the stage-2 hash table ``hashes.csv.gz`` under
   ``processed_dir()/{dataset}/shards[_sample]``, where ``train.fit``
   reads them.

Given the same input files, seed and options the shard files,
``manifest.json``, ``splits.json``, ``split.txt`` and ``vocab.json`` are
byte for byte those of the JAX package's script, and each package loads
the other's shards. Idempotent: an existing shard directory is left alone
unless ``--overwrite``, and one built under another ``--split`` is
refused. Preprocess runs on the host: it launches no kernel.

The extraction workers are threads, with the same output as the JAX
script's process-backed sessions; the port's
:class:`~deepdfa_tpu_torch.data.extraction.ProcessSession` is not wired in
here yet.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = ["main", "extract_streaming"]


def _log(msg: str) -> None:
    print(f"[preprocess] {msg}", file=sys.stderr)


class _ExtractSession:
    """One worker's session: extraction in this process (C source → CPG
    with dependence edges)."""

    def extract(self, code: str):
        from deepdfa_tpu_torch.cpg.features import add_dependence_edges
        from deepdfa_tpu_torch.cpg.frontend import parse_source

        return add_dependence_edges(parse_source(code))

    def close(self) -> None:
        pass


def _native_extract(session, row):
    return session.extract(str(row["before"]))


def _joern_setup(dataset: str):
    """``(session_factory, extract_fn, parse_after, supervisor)`` of the
    Joern path: each function's source lands under ``processed/{ds}/before``
    named by its id and content digest (a changed text never reuses stale
    artifacts), each pool worker drives its own REPL exporting
    ``.nodes/.edges/.dataflow.json`` through ``export_func_graph.sc``, read
    back with :func:`~deepdfa_tpu_torch.cpg.joern.load_cpg`.
    ``parse_after`` extracts after-patch versions for the statement labels
    through a lazily spawned supervised session; the caller closes the
    returned supervisor after labelling (a JVM must never leak)."""
    from deepdfa_tpu_torch import utils
    from deepdfa_tpu_torch.cpg.joern import load_cpg
    from deepdfa_tpu_torch.cpg.joern_session import JoernSession
    from deepdfa_tpu_torch.resilience.supervisor import ExtractionSupervisor

    src_dir = utils.get_dir(utils.processed_dir() / dataset / "before")
    after_dir = utils.get_dir(utils.processed_dir() / dataset / "after")

    def export_and_load(session, c_path: Path):
        stem = str(c_path)
        if not (Path(stem + ".nodes.json").exists()
                and Path(stem + ".edges.json").exists()):
            session.run_script("export_func_graph", {"filename": stem})
        return load_cpg(stem)

    def extract_fn(session, row):
        digest = hashlib.sha1(str(row["before"]).encode()).hexdigest()[:16]
        c_path = src_dir / f"{row['id']}_{digest}.c"
        if not c_path.exists():
            atomic_write_text(c_path, str(row["before"]))
        return export_and_load(session, c_path)

    supervisor = ExtractionSupervisor(lambda: JoernSession(worker_id=99))

    def parse_after(source: str):
        digest = hashlib.sha1(source.encode()).hexdigest()[:16]
        c_path = after_dir / f"{digest}.c"
        if not c_path.exists():
            atomic_write_text(c_path, source)
        return supervisor.run(f"after:{digest}",
                              lambda s: export_and_load(s, c_path))

    return (lambda wid: JoernSession(worker_id=wid)), extract_fn, \
        parse_after, supervisor


def extract_streaming(records: list[dict], out_dir: Path, *, workers: int,
                      dataset: str, use_cache: bool = True,
                      shard_size: int = 64, salt: str = "native",
                      session_factory=None, extract_fn=None):
    """Shard-chunked extraction of ``records``' ``before`` texts through the
    pool, with the cache in front and per-shard progress journaled to
    ``out_dir/build_journal.json``. Journaled shards read straight from
    the cache (a journaled entry missing from it re-extracts). The sessions
    and the per-item call default to the native front end.

    Returns ``(cpgs, failures, report)``: ``failures`` are
    ``failed_frontend.txt`` lines; quarantined functions are failure rows,
    never build aborts."""
    from deepdfa_tpu_torch import utils
    from deepdfa_tpu_torch.data.extract_cache import ExtractCache
    from deepdfa_tpu_torch.data.extraction import ExtractionPool
    from deepdfa_tpu_torch.pipeline import source_key
    from deepdfa_tpu_torch.resilience.journal import RunJournal

    session_factory = session_factory or (lambda wid: _ExtractSession())
    extract_fn = extract_fn or _native_extract
    cache = None
    if use_cache:
        cache = ExtractCache(
            utils.get_dir(utils.cache_dir() / "cpg_cache" / dataset), salt=salt)

    shard_size = max(1, shard_size)
    shards = [records[i:i + shard_size]
              for i in range(0, len(records), shard_size)]
    # the journal cursor is valid only for the same corpus in the same
    # order under the same sharding; anything else restarts at shard 0
    fingerprint = hashlib.sha1(json.dumps(
        [[r["id"], source_key(str(r["before"]))] for r in records]
        + [shard_size, salt]).encode()).hexdigest()
    journal = RunJournal(out_dir / "build_journal.json")
    start_shard = 0
    rec = journal.read()
    if cache is not None and rec and rec.get("fingerprint") == fingerprint:
        start_shard = min(int(rec.get("shards_done", 0)), len(shards))
        if start_shard:
            _log(f"journal: resuming at shard {start_shard}/{len(shards)}")

    cpgs: dict = {}
    failures: list[str] = []
    report = {"workers": max(1, workers), "restarts": 0, "quarantined": [],
              "steals": 0, "requeued": 0, "extracted": 0, "cache_hits": 0}

    def keep(fid, value) -> None:
        if value is not None and len(value):
            cpgs[fid] = value

    for si, shard in enumerate(shards):
        if si < start_shard:
            pending = []
            for row in shard:
                value = cache.get(cache.key(str(row["before"])))
                if value is None:
                    pending.append(row)
                else:
                    report["cache_hits"] += 1
                    keep(row["id"], value)
            shard = pending
            if not shard:
                continue
        pool = ExtractionPool(
            session_factory, n_workers=max(1, workers),
            cache=cache, cache_code=lambda row: str(row["before"]))
        for res in pool.run([(row["id"], row) for row in shard], extract_fn):
            if res.error is not None:
                failures.append(f"{res.key}\t{res.error}")
            else:
                keep(res.key, res.value)
        rep = pool.report()
        for k in ("restarts", "steals", "requeued", "extracted", "cache_hits"):
            report[k] += rep.get(k, 0)
        report["quarantined"].extend(rep["quarantined"])
        if cache is not None:
            # shard si is fully committed: its entries are on disk before
            # this record lands
            journal.write(fingerprint=fingerprint, shards_done=si + 1,
                          n_shards=len(shards), functions=len(records))
    report["resumed_from_shard"] = start_shard
    report["shards"] = len(shards)
    report["cache"] = cache.stats() if cache is not None else None
    return cpgs, failures, report


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deepdfa_tpu_torch.preprocess",
        description="C corpus → training-ready graph shards")
    parser.add_argument("--dataset", default="demo",
                        help="demo | demo_hard | demo_order{L} | bigvul | "
                        "devign | diversevul | mutated_<name>")
    parser.add_argument("--frontend", default="native",
                        choices=["native", "joern"])
    parser.add_argument("--n", type=int, default=200, help="demo corpus size")
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workers", type=int, default=6,
                        help="extraction thread sessions (and the Big-Vul "
                        "reader's diff processes)")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--limit-all", type=int, default=1000)
    parser.add_argument("--limit-subkeys", type=int, default=1000)
    parser.add_argument("--split", default="random",
                        help="random: seeded 70/10/20 (default); fixed: the "
                        "dataset's protocol split (LineVul for Big-Vul, "
                        "CodeXGLUE for Devign); any other value: a named "
                        "split csv under external/splits/<name>.csv. The "
                        "split decides the train-only vocabulary.")
    parser.add_argument("--dataflow-labels", action="store_true",
                        help="attach _DF_IN/_DF_OUT solver-solution node labels")
    parser.add_argument("--dataflow-families", action="store_true",
                        help="emit the static-analysis feature families "
                             "(_DFA_live_out/_DFA_uninit/_DFA_taint)")
    parser.add_argument("--validate", action="store_true",
                        help="drop graphs with structural error diagnostics "
                             "and report per-check counts")
    parser.add_argument("--no-cache", action="store_true",
                        help="disable the extraction cache (and with it the "
                             "resume journal)")
    parser.add_argument("--shard-size", type=int, default=64,
                        help="functions per journaled extraction shard")
    return parser


def _split(ids: list, args) -> dict[str, list]:
    """Seeded random 70/10/20, or the partition a split map gives."""
    import numpy as np

    from deepdfa_tpu_torch.data import ingest

    if args.split == "random":
        rng = np.random.default_rng(args.seed)
        perm = rng.permutation(len(ids))
        n_val, n_test = int(len(ids) * 0.1), int(len(ids) * 0.2)
        return {
            "val": [ids[i] for i in perm[:n_val]],
            "test": [ids[i] for i in perm[n_val : n_val + n_test]],
            "train": [ids[i] for i in perm[n_val + n_test :]],
        }
    smap = (ingest.splits_map(args.dataset) if args.split == "fixed"
            else ingest.named_splits(args.split))
    splits, unassigned = ingest.partition_ids(ids, smap)
    if unassigned:
        _log(f"{unassigned}/{len(ids)} functions not in split "
             f"{args.split!r} — excluded from all splits")
    if not splits["train"]:
        raise SystemExit(
            f"split {args.split!r} assigns no TRAIN functions from this "
            "corpus — the train-only vocabulary would be empty")
    return splits


def _ingest(args, stats: dict) -> tuple[list[dict], bool]:
    """The corpus as row dicts, and whether its labels are graph-level
    (Devign). ``stats`` receives the Big-Vul reader's filter counts."""
    if args.dataset in ("demo", "demo_hard") or args.dataset.startswith("demo_order"):
        from deepdfa_tpu_torch.data.codegen import demo_corpus

        chain_depth = (int(args.dataset[len("demo_order"):])
                       if args.dataset.startswith("demo_order") else None)
        records = demo_corpus(
            args.n if not args.sample else min(args.n, 60), seed=args.seed,
            style="hard" if args.dataset != "demo" else "easy",
            chain_depth=chain_depth,
        )
        return records, False
    from deepdfa_tpu_torch.data import ingest

    kw = {"stats": stats} if args.dataset == "bigvul" else {}
    rows = ingest.ds(args.dataset, sample=args.sample, workers=args.workers,
                     **kw)
    return list(rows), args.dataset == "devign"


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from deepdfa_tpu_torch import utils
    from deepdfa_tpu_torch.config import FeatureConfig
    from deepdfa_tpu_torch.cpg.frontend import parse_source
    from deepdfa_tpu_torch.cpg.ivdetect import statement_labels
    from deepdfa_tpu_torch.data.graphs import save_shards
    from deepdfa_tpu_torch.data.materialize import CorpusBuilder

    suffix = "_sample" if args.sample else ""
    out_dir = utils.processed_dir() / args.dataset / f"shards{suffix}"
    if (out_dir / "splits.json").exists() and not args.overwrite:
        # the split defines the train-only vocabulary: shards built under
        # another split must not be served (no marker = built random)
        marker = out_dir / "split.txt"
        recorded = marker.read_text().strip() if marker.exists() else "random"
        if recorded != args.split:
            raise SystemExit(
                f"{out_dir} was built with split {recorded!r}, not "
                f"{args.split!r} — pass --overwrite to rebuild (the vocab "
                "must be rebuilt for the new split)")
        print(json.dumps({"status": "exists", "out": str(out_dir)}))
        return {"status": "exists", "out": str(out_dir)}

    # 1. ingest
    seconds: dict[str, float] = {}
    ingest_stats: dict = {}
    t0 = time.perf_counter()
    records, graph_level = _ingest(args, ingest_stats)
    seconds["ingest"] = time.perf_counter() - t0

    # 2. extract
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    parse_after, supervisor = parse_source, None
    session_factory = extract_fn = None
    if args.frontend == "joern":
        session_factory, extract_fn, parse_after, supervisor = _joern_setup(
            args.dataset)
    cpgs, failures, extraction = extract_streaming(
        records, out_dir, workers=args.workers, dataset=args.dataset,
        use_cache=not args.no_cache, shard_size=args.shard_size,
        salt=args.frontend, session_factory=session_factory,
        extract_fn=extract_fn)
    seconds["extract"] = time.perf_counter() - t0
    failed_rate = len(failures) / max(len(records), 1)
    if failures:
        atomic_write_text(out_dir / "failed_frontend.txt",
                          "\n".join(failures) + "\n")
        _log(f"frontend failures: {len(failures)}/{len(records)} "
             f"({failed_rate:.1%}) — see {out_dir / 'failed_frontend.txt'}")

    # 3. structural validation
    validation = None
    if args.validate:
        from deepdfa_tpu_torch.data.ingest import validate_cpgs

        cpgs, validation = validate_cpgs(cpgs)
        validation.pop("error_graph_ids", None)
        _log(f"validator: {json.dumps(validation)}")

    # 4. labels: removed ∪ dependent-added lines through the corpus-wide
    # cache named by its content (a stale cache of another corpus never
    # matches), or Devign's graph labels. The native after-patch CPG is
    # parsed without dependence edges, as the JAX script parses it, so the
    # labels (and shards) stay equal (ROADMAP queue C)
    t0 = time.perf_counter()
    vuln_lines = graph_labels = None
    try:
        if graph_level:
            row_of = {r["id"]: r for r in records}
            graph_labels = {fid: int(row_of[fid].get("vul", 0)) for fid in cpgs}
        else:
            label_key = hashlib.sha1(json.dumps(
                [[r["id"], int(r.get("vul", 1)), list(r.get("removed") or []),
                  list(r.get("added") or [])] for r in records]
            ).encode()).hexdigest()[:16]
            stmt = statement_labels(
                records, cpgs, parse_after,
                cache_path=out_dir / f"statement_labels{suffix}_{label_key}.pkl",
                cache=not args.overwrite,
            )
            vuln_lines = {
                fid: set(stmt.get(fid, {}).get("removed", []))
                | set(stmt.get(fid, {}).get("depadd", []))
                for fid in cpgs
            }
    finally:  # a Joern session is a JVM: never leak it past labelling
        if supervisor is not None:
            supervisor.close()
    seconds["label"] = time.perf_counter() - t0

    # 5. split: decides the train-only vocabulary below
    splits = _split(sorted(cpgs), args)

    # 6. materialize
    t0 = time.perf_counter()
    builder = CorpusBuilder(
        FeatureConfig(limit_all=args.limit_all, limit_subkeys=args.limit_subkeys,
                      dataflow_families=args.dataflow_families)
    )
    graphs, vocabs = builder.build(
        cpgs, splits["train"], vuln_lines=vuln_lines,
        graph_labels=graph_labels, dataflow_labels=args.dataflow_labels,
    )
    n_shards = save_shards(graphs, out_dir)
    atomic_write_text(out_dir / "splits.json", json.dumps(splits))
    atomic_write_text(out_dir / "split.txt", args.split)
    # the full form (cfg + subkey vocabs + all_vocab): predict encodes new
    # source against it
    atomic_write_text(
        out_dir / "vocab.json",
        json.dumps({name: voc.to_dict() for name, voc in vocabs.items()}),
    )
    _write_hashes(out_dir / "hashes.csv.gz", builder.hash_rows)
    seconds["build"] = time.perf_counter() - t0
    summary = {
        "status": "ok",
        "out": str(out_dir),
        "functions": len(records),
        "cpgs": len(cpgs),
        "graphs": len(graphs),
        "failed": len(failures),
        "failed_rate": round(failed_rate, 4),
        "shards": n_shards,
        "vul_graphs": int(sum(g.node_feats["_VULN"].max() > 0 for g in graphs)),
    }
    if validation is not None:
        summary["validation"] = validation
    if ingest_stats:
        summary["ingest"] = ingest_stats
    if supervisor is not None:  # the labelling session's own restarts
        extraction["restarts"] += supervisor.report()["restarts"]
        extraction["quarantined"].extend(supervisor.report()["quarantined"])
    summary["extraction"] = {
        "workers": extraction["workers"],
        "restarts": extraction["restarts"],
        "quarantined": len(extraction["quarantined"]),
        "steals": extraction["steals"],
        "requeued": extraction["requeued"],
        "extracted": extraction["extracted"],
        "cache_hits": extraction["cache_hits"],
        "resumed_from_shard": extraction["resumed_from_shard"],
        "extraction_shards": extraction["shards"],
        "cache": extraction["cache"],
    }
    if extraction["quarantined"]:
        from deepdfa_tpu_torch.data.ingest import write_quarantine

        summary["quarantine_file"] = str(
            write_quarantine(out_dir, {"quarantined": extraction["quarantined"]})
        )
    if args.dataflow_families:
        summary["dataflow_families"] = True
    summary["seconds"] = seconds
    print(json.dumps(summary))
    return summary


def _write_hashes(path: Path, rows: list[dict]) -> None:
    """The stage-2 hash table as gzip CSV (columns ``graph_id, node_id,
    hash``): the JAX package's fallback when it has no parquet engine.
    Written sideways and moved into place."""
    import csv
    import gzip
    import io

    from deepdfa_tpu_torch.resilience.journal import atomic_write_bytes

    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(["graph_id", "node_id", "hash"])
    writer.writerows([r["graph_id"], r["node_id"], r["hash"]] for r in rows)
    atomic_write_bytes(path, gzip.compress(buf.getvalue().encode("utf-8")))


if __name__ == "__main__":
    main()
