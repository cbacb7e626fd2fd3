"""Dataset ingestion: raw corpora → labeled function tables.

A copy of ``deepdfa_tpu/data/ingest.py`` without pandas. A table is a
:class:`~deepdfa_tpu_torch.data.table.Rows`: row dicts with the JAX
frame's columns in its order (lists stay lists, ``id``/``vul``/``target``
are Python ints) and pandas' row labels beside them.

- comment stripping (:func:`remove_comments`, reference
  ``DDFA/sastvd/helpers/datasets.py:19-33``);
- diff labeling (:func:`diff_lines`, :func:`label_diffs`: combined-view line
  labels computed with ``difflib``, the contract of the reference's
  ``helpers/git.py``), in row order over any worker pool;
- the readers: Big-Vul's MSR CSV with its quality filters
  (:func:`bigvul`), Devign's ``function.json`` (:func:`devign`), the
  DiverseVul JSONL (:func:`diversevul`) and the mutated variants
  (:func:`mutated`), dispatched by :func:`ds`;
- extraction-artifact filters (:func:`itempath`, :func:`check_validity`,
  :func:`filter_dataset` with the validity cache
  ``{ds}_valid_{sample_mode}.csv``, shared with the JAX package byte for
  byte);
- the split files (:func:`linevul_splits`, :func:`codexglue_splits`,
  :func:`named_splits`, :func:`splits_map`) and partitioning
  (:func:`partition_ids`, :func:`partition`);
- structural validation at ingestion (:func:`validate_cpgs`), the
  extraction quarantine report, and :class:`VulnDataset`.

The readers cache their table under ``cache_dir()/minimal_datasets`` as
``port_minimal_{name}[_sample].json``, a file of the port's own: the port
never reads the JAX package's pickled or parquet frames. As in JAX, only the
default source fills the cache; a custom path never does.
"""

from __future__ import annotations

import difflib
import json
import re
from glob import glob
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

from deepdfa_tpu_torch import utils
from deepdfa_tpu_torch.data import table
from deepdfa_tpu_torch.data.table import NAN, Rows, isna
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = [
    "remove_comments",
    "diff_lines",
    "label_diffs",
    "bigvul",
    "devign",
    "diversevul",
    "mutated",
    "ds",
    "itempath",
    "check_validity",
    "filter_dataset",
    "linevul_splits",
    "codexglue_splits",
    "named_splits",
    "partition_ids",
    "splits_map",
    "partition",
    "validate_cpgs",
    "QUARANTINE_FILE",
    "read_quarantine",
    "write_quarantine",
    "VulnDataset",
]

_COMMENT_OR_STRING = re.compile(
    # string literals first so comment markers inside them survive
    r'"(?:\\.|[^"\\])*"'
    r"|'(?:\\.|[^'\\])*'"
    r"|/\*.*?\*/"
    r"|//[^\n]*",
    re.DOTALL,
)


def remove_comments(text: str) -> str:
    """Strip ``//`` and ``/* */`` comments from C code, leaving string
    literals intact. A comment becomes a single space, as in the reference
    (``datasets.py:19-33``)."""

    def _repl(m: re.Match) -> str:
        s = m.group(0)
        return " " if s.startswith("/") else s

    return _COMMENT_OR_STRING.sub(_repl, text)


# ---------------------------------------------------------------------------
# diff labeling (combined-view line numbers)


def diff_lines(before: str, after: str) -> dict:
    """Combined diff of two function versions.

    Returns ``{"diff", "added", "removed", "before", "after"}``: ``diff``
    is every line of the combined view prefixed with ``" "``, ``"-"`` or
    ``"+"``; ``added``/``removed`` are 1-based line numbers into the
    combined view (``git.py:74-79``); ``before``/``after`` are the combined
    views with the other side's lines commented out (``git.py:128-165``),
    so line numbers agree across both versions.
    """
    old_lines = before.splitlines()
    new_lines = after.splitlines()
    sm = difflib.SequenceMatcher(a=old_lines, b=new_lines, autojunk=False)
    diff: list[str] = []
    added: list[int] = []
    removed: list[int] = []
    view_before: list[str] = []
    view_after: list[str] = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            for line in old_lines[i1:i2]:
                diff.append(" " + line)
                view_before.append(line)
                view_after.append(line)
        else:
            for line in old_lines[i1:i2]:
                diff.append("-" + line)
                removed.append(len(diff))
                view_before.append(line)
                view_after.append("// " + line)
            for line in new_lines[j1:j2]:
                diff.append("+" + line)
                added.append(len(diff))
                view_before.append("// " + line)
                view_after.append(line)
    return {
        "diff": "\n".join(diff),
        "added": added,
        "removed": removed,
        "before": "\n".join(view_before),
        "after": "\n".join(view_after),
    }


_DIFF_COLS = ("diff", "added", "removed", "before", "after")


def _label_one(item: tuple) -> dict:
    func_before, func_after = item
    if func_before == func_after:
        return {"diff": "", "added": [], "removed": [],
                "before": func_before, "after": func_before}
    return diff_lines(func_before, func_after)


def _strip_and_label(item: tuple) -> tuple[str, str, dict]:
    """One Big-Vul row's pass: both versions comment-stripped, then
    diff-labelled (the JAX reader's three maps in one)."""
    before, after = remove_comments(item[0]), remove_comments(item[1])
    return before, after, _label_one((before, after))


def _ordered_map(fn: Callable, items: list, workers: int) -> list:
    """``[fn(x) for x in items]``, over a pool of spawned processes when
    ``workers > 1``; results keep the input order."""
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=workers, maxtasksperchild=64) as pool:
        return list(pool.imap(fn, items, 32))


def _with_columns(rows: Rows, infos: list[dict]) -> Rows:
    """``rows`` with the diff columns replaced by ``infos``' (appended)."""
    keep = [c for c in rows.columns if c not in _DIFF_COLS]
    out = [{**{c: r[c] for c in keep}, **info} for r, info in zip(rows, infos)]
    return Rows(out, keep + list(_DIFF_COLS), rows.index)


def label_diffs(rows: Rows, workers: int = 6) -> Rows:
    """Attach the diff/added/removed/before/after columns of each row's
    ``func_before``/``func_after`` pair (``datasets.py:207-217``), mapped
    over ``workers`` processes, in row order."""
    infos = _ordered_map(_label_one, [(r["func_before"], r["func_after"])
                                      for r in rows], workers)
    return _with_columns(rows, infos)


# ---------------------------------------------------------------------------
# the readers' cache: a JSON file of the port's own


def _cache_path(name: str, sample: bool) -> Path:
    d = utils.get_dir(utils.cache_dir() / "minimal_datasets")
    return d / f"port_minimal_{name}{'_sample' if sample else ''}.json"


def _cache_save(rows: Rows, path: Path) -> None:
    atomic_write_text(path, json.dumps(
        {"columns": rows.columns,
         "rows": [[r[c] for c in rows.columns] for r in rows]}))


def _cache_load(path: Path) -> Rows | None:
    """The cached table, rows holding a NaN dropped (the JAX loader's
    ``dropna``), or None when there is no readable cache."""
    try:
        data = json.loads(path.read_text())
        columns = data["columns"]
        rows = [dict(zip(columns, vals)) for vals in data["rows"]]
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return Rows((r for r in rows if not any(isna(v) for v in r.values())),
                columns)


def _cached(name: str, cache: bool, sample: bool, path,
            read: Callable) -> Rows:
    """``read(path)``, through the cache when ``path`` is the default
    source (None)."""
    cache_file = _cache_path(name, sample)
    if cache and path is None:
        cached = _cache_load(cache_file)
        if cached is not None:
            return cached
    out = read(path)
    # only the canonical source may fill the shared cache: a custom path
    # (subsets, tests) must not poison later default loads
    if cache and path is None:
        _cache_save(out, cache_file)
    return out


# ---------------------------------------------------------------------------
# readers


_MINIMAL_COLS = ["id", "before", "after", "removed", "added", "diff", "vul",
                 "dataset"]


def _abnormal_ending(code: str) -> bool:
    """Functions that do not end in ``}``/``;`` were truncated upstream
    (``datasets.py:223-238``)."""
    stripped = code.strip()
    return not stripped or stripped[-1] not in ("}", ";")


def _set(row: dict, columns: list[str], name: str, value) -> None:
    """``df[name] = value`` for one row: a new column goes last."""
    if name not in row and name not in columns:
        columns.append(name)
    row[name] = value


def _with_id(rows: Rows) -> Rows:
    """``rename_axis("id").reset_index()``: the row position as a first
    ``id`` column."""
    if "id" in rows.columns:
        raise ValueError("cannot insert id, already exists")
    return Rows([{"id": i, **r} for i, r in enumerate(rows)],
                ["id"] + rows.columns)


def _read_bigvul(csv_path, workers: int, stats: dict | None) -> Rows:
    rows = table.read_csv(csv_path, str_columns=("commit_id", "project"))
    columns = ["id" if c == "Unnamed: 0" else c for c in rows.columns]
    rows = Rows(({("id" if k == "Unnamed: 0" else k): v
                  for k, v in r.items()} for r in rows), columns)
    if "id" not in rows.columns:
        rows = _with_id(rows)
    columns = rows.columns
    for r in rows:
        _set(r, columns, "dataset", "bigvul")
        r["vul"] = int(r["vul"])

    done = _ordered_map(_strip_and_label,
                        [(r["func_before"], r["func_after"]) for r in rows],
                        workers)
    for r, (before, after, _) in zip(rows, done):
        r["func_before"], r["func_after"] = before, after
    rows = _with_columns(rows, [info for _, _, info in done])

    # the quality filters, on the vulnerable rows only
    filters = (
        ("no_change", lambda r: len(r["added"]) + len(r["removed"]) > 0),
        ("abnormal_before", lambda r: not _abnormal_ending(r["func_before"])),
        ("abnormal_after", lambda r: not _abnormal_ending(r["func_after"])),
        ("call_ending", lambda r: not r["before"].strip().endswith(");")),
        ("modified_share", lambda r: (len(r["added"]) + len(r["removed"]))
         / max(len(r["diff"].splitlines()), 1) < 0.7),
        ("short", lambda r: len(r["before"].splitlines()) > 5),
    )
    dfv = [r for r in rows if r["vul"] == 1]
    dropped = {}
    for name, keep in filters:
        kept = [r for r in dfv if keep(r)]
        dropped[name] = len(dfv) - len(kept)
        dfv = kept
    keep_vul = {r["id"] for r in dfv}
    out = [r for r in rows if r["vul"] == 0 or r["id"] in keep_vul]
    if stats is not None:
        stats.update(rows=len(rows), vulnerable=sum(r["vul"] == 1 for r in rows),
                     dropped=dropped, kept=len(out),
                     kept_vulnerable=sum(r["vul"] == 1 for r in out))
    return Rows(out, rows.columns).select(_MINIMAL_COLS)


def bigvul(csv_path: str | Path | None = None, cache: bool = True,
           sample: bool = False, workers: int = 6,
           stats: dict | None = None) -> Rows:
    """Big-Vul (MSR) reader: CSV → comment-strip → diff labels → quality
    filters → minimal table (``datasets.py:139-292``).

    The filters apply to vulnerable rows only (a row with ``vul`` neither 0
    nor 1 is dropped): no-change diffs, abnormal endings, a combined view
    ending in ``");"``, a modified share ≥ 0.7 and ≤ 5 lines. The strip and
    the diff run in one pass over ``workers`` processes. ``stats``, when
    given, receives the rows read, the vulnerable rows each filter dropped
    (``dropped``) and the rows kept (a cached table leaves it empty).
    """
    def read(path):
        if path is None:
            name = "MSR_data_cleaned_SAMPLE.csv" if sample else "MSR_data_cleaned.csv"
            path = utils.external_dir() / name
        return _read_bigvul(path, workers, stats)

    return _cached("bigvul", cache, sample, csv_path, read)


def _read_functions(path, lines: bool, dataset: str) -> Rows:
    """Devign/DiverseVul's common part: the row position as ``id``, the
    stripped ``before`` (blank lines folded), abnormal endings dropped."""
    rows = _with_id(table.read_json(path, lines=lines))
    columns = rows.columns
    for r in rows:
        _set(r, columns, "dataset", dataset)
        _set(r, columns, "before",
             remove_comments(r["func"]).replace("\n\n", "\n"))
    return rows.where(not _abnormal_ending(r["before"]) for r in rows)


def _with_vul(rows: Rows) -> None:
    for r in rows:
        _set(r, rows.columns, "vul", int(r["target"]))


def devign(json_path: str | Path | None = None, cache: bool = True,
           sample: bool = False) -> Rows:
    """Devign reader: ``function.json`` → graph-level labels only
    (``datasets.py:36-102``); no line labels (no before/after pairs)."""
    def read(path):
        rows = _read_functions(path or utils.external_dir() / "function.json",
                               False, "devign")
        rows = rows.where(not r["before"].strip().endswith(");") for r in rows)
        _with_vul(rows)
        if sample:
            rows = rows.take(range(min(50, len(rows))))
        return rows.select(["id", "dataset", "before", "target", "vul"]) \
            .reset_index()

    return _cached("devign", cache, sample, json_path, read)


def _clean(value) -> str:
    """A ``cwe``/``message`` cell as text: a list joined with commas, a
    missing value empty (never the text ``"nan"``)."""
    if isinstance(value, (list, tuple)):
        return ",".join(str(x) for x in value)
    if isna(value):
        return ""
    return str(value)


def diversevul(json_path: str | Path | None = None, cache: bool = True,
               sample: bool = False) -> Rows:
    """DiverseVul reader: the published ``diversevul_*.json`` JSONL, one
    object per function (``func``, ``target``, ``cwe`` (list),
    ``project``, ``commit_id``, ``message``). Keeps the explanation columns
    ``cwe`` and ``message`` as text."""
    def read(path):
        rows = _read_functions(
            path or utils.external_dir() / "diversevul.json", True,
            "diversevul")
        _with_vul(rows)
        for name in ("cwe", "message"):
            for r in rows:
                _set(r, rows.columns, name, _clean(r.get(name, "")))
        if sample:
            rows = rows.take(range(min(50, len(rows))))
        return rows.select(["id", "dataset", "before", "target", "vul", "cwe",
                            "message"]).reset_index()

    return _cached("diversevul", cache, sample, json_path, read)


def _merge_inner(left: Rows, right: Rows, left_on: str, right_on: str) -> Rows:
    """``pd.merge(left, right, left_on=, right_on=, how="inner")``: left
    rows in order, each with its matches in right order (a repeated key
    repeats the left row); shared column names get ``_x``/``_y``."""
    shared = set(left.columns) & set(right.columns)
    lname = {c: f"{c}_x" if c in shared else c for c in left.columns}
    rname = {c: f"{c}_y" if c in shared else c for c in right.columns}
    matches: dict = {}
    for r in right:
        matches.setdefault(r[right_on], []).append(r)
    out = [{**{lname[c]: lr[c] for c in left.columns},
            **{rname[c]: rr[c] for c in right.columns}}
           for lr in left for rr in matches.get(lr[left_on], ())]
    return Rows(out, [lname[c] for c in left.columns]
                + [rname[c] for c in right.columns])


def mutated(subdataset: str, cache: bool = True, sample: bool = False,
            workers: int = 6) -> Rows:
    """Mutation-robustness variants: Big-Vul rows joined with mutated sources
    (``datasets.py:105-126``) on ``id == idx``. ``*_flip`` uses the
    mutation's ``source`` column, the others its ``target``."""
    rows = bigvul(cache=cache, sample=sample, workers=workers) \
        .drop(["dataset", "before"])
    fp = utils.external_dir() / "mutated" / \
        f"c_{subdataset.replace('_flip', '')}.jsonl"
    mut = table.read_json(fp, lines=True)
    col = "source" if "flip" in subdataset else "target"
    mut = mut.drop(c for c in ("source", "target") if c != col)
    mut = Rows(({("before" if k == col else k): v for k, v in r.items()}
                for r in mut),
               ["before" if c == col else c for c in mut.columns])
    rows = _merge_inner(rows, mut, "id", "idx")
    for r in rows:
        _set(r, rows.columns, "dataset", f"mutated_{subdataset}")
    return rows.drop(["after", "added", "removed", "diff"])


def ds(dsname: str, cache: bool = True, sample: bool = False,
       workers: int = 6, **kw) -> Rows:
    """Dataset dispatcher (``datasets.py:129-137``). ``workers`` reaches
    the readers that map over processes (Big-Vul and the mutated sets)."""
    if dsname == "bigvul":
        return bigvul(cache=cache, sample=sample, workers=workers, **kw)
    if dsname == "devign":
        return devign(cache=cache, sample=sample, **kw)
    if dsname == "diversevul":
        return diversevul(cache=cache, sample=sample, **kw)
    if dsname.startswith("mutated"):
        return mutated(dsname.split("_", maxsplit=1)[1], cache=cache,
                       sample=sample, workers=workers)
    raise ValueError(f"unknown dataset {dsname!r}")


# ---------------------------------------------------------------------------
# extraction-artifact filters


def itempath(_id, dsname: str = "bigvul") -> Path:
    """Path of the per-function source file whose extraction artifacts
    (``.nodes.json``/``.edges.json``/``.dataflow.json``) sit next to it
    (``datasets.py:333-335``)."""
    return utils.processed_dir() / dsname / "before" / f"{_id}.c"


def check_validity(_id, dsname: str = "bigvul",
                   require_line_number: bool = False,
                   require_dataflow: bool = False) -> bool:
    """A sample is valid when its extracted graph parses, has ≥1 node with a
    line number (when required), and (optionally) has dataflow edges
    (``datasets.py:295-330``)."""
    path = itempath(_id, dsname)
    try:
        with open(f"{path}.nodes.json") as f:
            nodes = json.load(f)
        with open(f"{path}.edges.json") as f:
            edges = json.load(f)
    except (OSError, ValueError):
        return False
    if not nodes or not edges:
        return False
    if not any("lineNumber" in n for n in nodes) and require_line_number:
        return False
    etypes = {e[2] for e in edges}
    if require_dataflow and not ({"REACHING_DEF", "CDG"} & etypes):
        return False
    return True


def _as_rows(rows) -> Rows:
    return rows if isinstance(rows, Rows) else Rows(rows)


def filter_dataset(
    rows: Iterable[dict],
    dsname: str,
    check_file: bool = False,
    check_valid: bool = False,
    vulonly: bool = False,
    load_code: bool = True,
    sample: int = -1,
    sample_mode: bool = False,
    seed: int = 0,
    validity_fn: Callable | None = None,
) -> Rows:
    """Training-time dataset filters (``datasets.py:352-405``): an optional
    random subsample (``df.sample(k, random_state=seed)``: the positions
    ``RandomState(seed).choice(n, k, replace=False)``, in that order),
    vul-only, rows with no extraction artifacts on disk dropped (their
    files named ``{id}.c``), rows failing validity dropped (through the
    validity cache, or ``validity_fn``, which bypasses it). Row labels are
    kept. Raises ``ValueError`` when no row is left (the JAX package
    asserts)."""
    rows = _as_rows(rows)
    if sample > 0:
        rows = rows.take(np.random.RandomState(seed).choice(
            len(rows), sample, replace=False))
    if vulonly:
        rows = rows.where(r["vul"] == 1 for r in rows)
    if check_file:
        have = {
            int(Path(p).name.split(".")[0])
            for p in glob(str(utils.processed_dir() / dsname / "before"
                              / "*.nodes.json"))
            if not Path(p).name.startswith("~")
        }
        rows = rows.where(r["id"] in have for r in rows)
    if check_valid:
        # a custom validity_fn bypasses the shared cache: the file is keyed
        # only by (dsname, sample_mode) and stays tied to the default check
        if validity_fn is not None:
            rows = rows.where(bool(validity_fn(r["id"])) for r in rows)
        else:
            cache = utils.cache_dir() / f"{dsname}_valid_{sample_mode}.csv"
            if cache.exists():
                valid = {r["id"] for r in table.read_csv(cache)
                         if r["valid"] is True}
            else:
                flags = [check_validity(r["id"], dsname) for r in rows]
                table.write_csv(cache, Rows(
                    ({"id": r["id"], "valid": f} for r, f in zip(rows, flags)),
                    ["id", "valid"], rows.index))
                valid = {r["id"] for r, f in zip(rows, flags) if f}
            rows = rows.where(r["id"] in valid for r in rows)
    if not rows:
        raise ValueError("all rows filtered out")
    if not load_code:
        rows = rows.drop(["before", "after", "removed", "added", "diff"])
    return rows


# ---------------------------------------------------------------------------
# splits


def _split_map(rows: Rows, key: str, rename: dict) -> dict:
    return {r[key]: rename.get(r["split"], r["split"]) for r in rows}


def linevul_splits(path: str | Path | None = None) -> dict:
    """Fixed Big-Vul splits (LineVul protocol) as ``{id: split}``, keyed by
    the file's first column (``datasets.py:449-454``); ``valid`` reads as
    ``val``."""
    rows = table.read_csv(path or utils.external_dir() / "linevul_splits.csv")
    return _split_map(rows, rows.columns[0], {"valid": "val"})


def codexglue_splits(path: str | Path | None = None) -> dict:
    """Fixed Devign splits (CodeXGLUE protocol) as ``{example_index:
    split}`` (``datasets.py:457-462``)."""
    rows = table.read_csv(path or utils.external_dir() / "codexglue_splits.csv")
    return _split_map(rows, "example_index", {"valid": "val"})


def named_splits(name: str, path: str | Path | None = None) -> dict:
    """Named cross-project split file ``external/splits/{name}.csv``
    (``datasets.py:465-473``) as ``{example_index: split}``: ``valid`` reads
    as ``val`` and ``holdout`` folds into ``test``."""
    rows = table.read_csv(path or utils.external_dir() / "splits"
                          / f"{name}.csv")
    return _split_map(rows, "example_index", {"valid": "val", "holdout": "test"})


def partition_ids(ids, smap: dict) -> tuple[dict[str, list], int]:
    """Bucket ``ids`` by a split map into train/val/test; ids the map does
    not assign are excluded from every split and counted. One
    implementation for preprocess-time and load-time partitioning."""
    splits: dict[str, list] = {"train": [], "val": [], "test": []}
    unassigned = 0
    for fid in ids:
        part = smap.get(fid)
        if part in splits:
            splits[part].append(fid)
        else:
            unassigned += 1
    return splits, unassigned


def splits_map(dsname: str) -> dict:
    """The dataset's fixed protocol split (``datasets.py:431-438``): the
    LineVul split for Big-Vul and its mutations, CodeXGLUE's for Devign;
    any other dataset has none."""
    if dsname == "bigvul" or dsname.startswith("mutated"):
        return linevul_splits()
    if dsname == "devign":
        return codexglue_splits()
    raise ValueError(dsname)


def partition(
    rows: Iterable[dict],
    part: str,
    dsname: str = "bigvul",
    split: str = "fixed",
    seed: int = 0,
    splits: dict | None = None,
) -> Rows:
    """Label rows with train/val/test in a ``label`` column (NaN where the
    map has no entry) and select one partition unless ``part == "all"``
    (``datasets.py:475-520``).

    ``split="random"`` holds out the fixed test set, then gives 10/10/80 %
    of the rest to val/test/train through ``RandomState(seed).permutation``
    of the row labels, with the reference's quirk: position ``i`` of the
    unpermuted range decides the split, the permutation decides which row
    gets position ``i``. ``"linevul"`` reads ``bigvul_rand_splits.csv``; any
    other name a named split file."""
    rows = _as_rows(rows)
    if split == "random":
        smap = splits if splits is not None else splits_map(dsname)
        rows = rows.where(smap.get(r["id"], NAN) != "test" for r in rows)
        n = len(rows)
        perm = np.random.RandomState(seed=seed).permutation(
            np.asarray(rows.index))
        n_val, n_test = int(n * 0.1), int(n * 0.2)
        by_label = {int(label): ("val" if i < n_val else "test" if i < n_test
                                 else "train") for i, label in enumerate(perm)}
        labels = [by_label[label] for label in rows.index]
    else:
        if splits is not None:
            smap = splits
        elif split == "fixed":
            smap = splits_map(dsname)
        elif split == "linevul":
            smap = _split_map(table.read_csv(
                utils.external_dir() / "bigvul_rand_splits.csv"), "id", {})
        else:
            smap = named_splits(split)
        labels = [smap.get(r["id"], NAN) for r in rows]
    columns = list(rows.columns)
    out = []
    for r, label in zip(rows, labels):
        r = dict(r)
        _set(r, columns, "label", label)
        out.append(r)
    rows = Rows(out, columns, rows.index)
    if part != "all":
        rows = rows.where(r["label"] == part for r in rows)
    return rows


# ---------------------------------------------------------------------------
# structural validation and the quarantine report


def validate_cpgs(cpgs: dict, drop_errors: bool = True) -> tuple[dict, dict]:
    """Run the structural validator over ``{graph_id: CPG}``.

    Returns ``(kept_cpgs, summary)``: graphs with error diagnostics are
    dropped when ``drop_errors``; the summary is ``validate_corpus``'s
    per-check aggregate."""
    from deepdfa_tpu_torch.cpg.validate import validate_corpus

    summary = dict(validate_corpus(cpgs.items()))
    if not drop_errors:
        return cpgs, summary
    bad = set(summary["error_graph_ids"])
    kept = {gid: cpg for gid, cpg in cpgs.items() if gid not in bad}
    return kept, summary


QUARANTINE_FILE = "quarantine.json"


def write_quarantine(out_dir: str | Path, report: dict) -> Path:
    """Persist an extraction supervisor's report (``{"quarantined": [...]}``)
    next to the shard output, atomically. Returns the file path."""
    path = Path(out_dir) / QUARANTINE_FILE
    atomic_write_text(path, json.dumps(report, indent=2, default=str))
    return path


def read_quarantine(out_dir: str | Path) -> dict:
    """The recorded quarantine report, or an empty one when the build
    quarantined nothing (the file is only written when non-empty)."""
    path = Path(out_dir) / QUARANTINE_FILE
    if not path.exists():
        return {"restarts": 0, "quarantined": []}
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# dataset class


class VulnDataset:
    """Partitioned function-level dataset with per-epoch rebalancing
    (``dclass.py:18-118``): filter → partition → ``idx2id``;
    :meth:`epoch_ids` re-draws the undersampled non-vul subset every epoch,
    seeded by (seed, epoch). ``rows`` stands in for the JAX class's ``df``.
    """

    def __init__(
        self,
        dsname: str = "bigvul",
        part: str = "train",
        seed: int = 0,
        sample: int = -1,
        sample_mode: bool = False,
        split: str = "fixed",
        undersample: str | float | None = None,
        oversample: float | None = None,
        check_file: bool = True,
        check_valid: bool = True,
        vulonly: bool = False,
        rows: Iterable[dict] | None = None,
        splits: dict | None = None,
    ):
        self.part = part
        self.undersample = undersample
        self.oversample = oversample
        self.seed = seed
        if rows is None:
            rows = ds(dsname, sample=sample_mode)
        rows = filter_dataset(
            rows, dsname, check_file=check_file, check_valid=check_valid,
            vulonly=vulonly, load_code=True, sample=sample,
            sample_mode=sample_mode, seed=seed)
        if not sample_mode:
            rows = partition(rows, part, dsname, split=split, seed=seed,
                             splits=splits)
        self.rows = rows.reset_index()
        self.idx2id = {i: r["id"] for i, r in enumerate(self.rows)}

    def vuln_lines(self, _id) -> dict[int, int]:
        """Removed (= vulnerable) line numbers for one function
        (``dclass.py:78-82``)."""
        found = [r for r in self.rows if r["id"] == _id]
        if len(found) != 1:
            raise ValueError(f"{len(found)} rows have id {_id!r}")
        return {i: 1 for i in found[0]["removed"]}

    def _vul(self) -> np.ndarray:
        return np.asarray([r["vul"] for r in self.rows], dtype=np.int64)

    def epoch_ids(self, epoch: int = 0, shuffle: bool = True) -> np.ndarray:
        """Example ids to visit this epoch (rebalanced, reshuffled)."""
        from deepdfa_tpu_torch.data.sampler import epoch_indices

        idx = epoch_indices(self._vul(), undersample=self.undersample,
                            oversample=self.oversample, seed=self.seed,
                            epoch=epoch, shuffle=shuffle)
        return np.asarray([r["id"] for r in self.rows])[idx]

    def positive_weight(self) -> float:
        from deepdfa_tpu_torch.data.sampler import positive_weight

        return positive_weight(self._vul())

    def __getitem__(self, idx: int) -> dict:
        return dict(self.rows[idx])

    def __len__(self) -> int:
        return len(self.rows)

    def __repr__(self) -> str:
        frac = round(float((self._vul() == 1).mean()), 3) if self.rows else 0.0
        return f"VulnDataset(part={self.part}, n={len(self.rows)}, vul%={frac})"
