"""Dataset ingestion: the corpus-independent part.

A copy of the pure half of ``deepdfa_tpu/data/ingest.py`` without pandas:

- comment stripping (:func:`remove_comments`, reference
  ``DDFA/sastvd/helpers/datasets.py:19-33``);
- diff labeling (:func:`diff_lines`: combined-view line labels computed
  with ``difflib``, the contract of the reference's ``helpers/git.py``);
- named split files and partitioning (:func:`named_splits`,
  :func:`partition_ids`);
- structural validation at ingestion (:func:`validate_cpgs`) and the
  extraction quarantine report (:func:`write_quarantine`,
  :func:`read_quarantine`).

The real-dataset readers (Big-Vul, Devign, DiverseVul, mutated), their
filters, the LineVul/CodeXGLUE split readers, ``partition`` and
``VulnDataset`` are not ported yet: ROADMAP queue A, "A14's rest (b)".
"""

from __future__ import annotations

import csv
import difflib
import json
import re
from pathlib import Path

from deepdfa_tpu_torch import utils
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = [
    "READERS_ITEM",
    "remove_comments",
    "diff_lines",
    "named_splits",
    "partition_ids",
    "splits_map",
    "validate_cpgs",
    "QUARANTINE_FILE",
    "read_quarantine",
    "write_quarantine",
]

# the ROADMAP item that ports the real-dataset readers
READERS_ITEM = "ROADMAP queue A, \"A14's rest (b)\""

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


def _ids(values: list[str]) -> list:
    """A column of ids as ints when every value is one, else as strings
    (the type pandas would infer for the column)."""
    try:
        return [int(v) for v in values]
    except ValueError:
        return values


def named_splits(name: str, path: str | Path | None = None) -> dict:
    """Named cross-project split file ``external/splits/{name}.csv``
    (``datasets.py:465-473``) as ``{example_index: split}``: the reference's
    leading row-index column is skipped, ``valid`` reads as ``val`` and
    ``holdout`` folds into ``test``."""
    path = Path(path) if path is not None else (
        utils.external_dir() / "splits" / f"{name}.csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    col = {c: k for k, c in enumerate(header)}
    rename = {"valid": "val", "holdout": "test"}
    ids = _ids([r[col["example_index"]] for r in body])
    return {i: rename.get(r[col["split"]], r[col["split"]])
            for i, r in zip(ids, body)}


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
    LineVul split for Big-Vul and its mutations, CodeXGLUE's for Devign.
    Their readers are not ported yet; any other dataset has none."""
    if dsname in ("bigvul", "devign") or dsname.startswith("mutated"):
        raise NotImplementedError(
            f"the fixed split of {dsname!r} is read by the dataset readers, "
            f"not ported yet: {READERS_ITEM}")
    raise ValueError(dsname)


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
