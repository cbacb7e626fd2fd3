"""Tables without pandas: the part of pandas' readers and CSV writer that
the dataset readers use.

A table is a :class:`Rows`: a list of row dicts whose keys are the column
names in column order, with pandas' row labels (``index``) and column
order (``columns``) beside it. A missing value is ``float("nan")``, as
``DataFrame.to_dict("records")`` gives it.

- :func:`read_csv` reads what ``pd.read_csv(path, dtype={c: str})`` reads
  with the C parser's defaults: quoted fields that span lines and hold
  doubled quotes, blank lines skipped, an empty header named
  ``Unnamed: {i}`` and a repeated one ``{name}.1``, pandas' default NA
  strings as NaN, and each column typed as the parser types it (int64;
  float64, also for ints beside a NaN; bool; else strings). Python's
  field size limit is raised first: the longest Big-Vul functions are
  longer than its default 131,072 characters.
- :func:`read_json` reads what ``pd.read_json(path)`` reads for a JSON
  array of objects, or ``lines=True`` for one object a line: the columns in
  order of first appearance, a missing key as NaN, and pandas' dtype
  inference (a column of numeric strings becomes numbers, integral floats
  ints). Unlike pandas it does not turn date-named columns into
  timestamps: no reader uses one.
- :func:`write_csv` writes the bytes ``DataFrame.to_csv(path)`` writes for
  columns of ints, strings and bools (pandas writes through the same
  ``csv`` module).
"""

from __future__ import annotations

import csv
import gzip
import json
import math
import re
import sys
from pathlib import Path
from typing import Any, Iterable

__all__ = ["NAN", "Rows", "isna", "read_csv", "read_json", "write_csv"]

NAN = float("nan")

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_FLOAT = re.compile(
    r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*\Z",
    re.IGNORECASE)


def isna(value: Any) -> bool:
    """pandas' NA test for one scalar: None or a float NaN."""
    return value is None or (isinstance(value, float) and math.isnan(value))


class Rows(list):
    """A table: a list of row dicts in row order, with ``columns`` (the
    column order) and ``index`` (pandas' row labels, ``0..n-1`` for a table
    a reader returns)."""

    def __init__(self, rows: Iterable[dict] = (), columns=None, index=None):
        super().__init__(rows)
        if columns is None:
            columns = list(self[0]) if self else []
        self.columns = list(columns)
        self.index = list(range(len(self)) if index is None else index)
        if len(self.index) != len(self):
            raise ValueError(f"{len(self.index)} labels for {len(self)} rows")

    def take(self, positions: Iterable[int]) -> "Rows":
        """The rows at ``positions``, in that order, with their labels."""
        positions = [int(p) for p in positions]
        return Rows([self[p] for p in positions], self.columns,
                    [self.index[p] for p in positions])

    def where(self, keep: Iterable[bool]) -> "Rows":
        """The rows whose ``keep`` entry is true, with their labels."""
        return self.take(i for i, k in enumerate(keep) if k)

    def select(self, columns: Iterable[str]) -> "Rows":
        """Only ``columns``, in that order (a missing one raises KeyError)."""
        columns = list(columns)
        return Rows([{c: r[c] for c in columns} for r in self], columns,
                    self.index)

    def drop(self, columns: Iterable[str]) -> "Rows":
        """Without ``columns`` (absent ones are ignored)."""
        gone = set(columns)
        return self.select(c for c in self.columns if c not in gone)

    def reset_index(self) -> "Rows":
        """The same rows labelled ``0..n-1``."""
        return Rows(self, self.columns)


def _raise_field_limit() -> None:
    limit = sys.maxsize
    while True:
        try:
            csv.field_size_limit(limit)
            return
        except OverflowError:  # a C long narrower than Py_ssize_t
            limit //= 2


def _header(names: list[str]) -> list[str]:
    out: list[str] = []
    seen: dict[str, int] = {}
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        if name in seen:
            k = seen[name]
            while f"{name}.{k}" in seen:
                k += 1
            seen[name] = k + 1
            name = f"{name}.{k}"
        seen.setdefault(name, 1)
        out.append(name)
    return out


def _csv_column(raw: list[str | None], as_str: bool) -> list:
    """One column's values typed as pandas' C parser types them."""
    na = [v is None or v in NA_STRINGS for v in raw]
    if as_str:
        return [NAN if n else v for v, n in zip(raw, na)]
    present = [v for v, n in zip(raw, na) if not n]
    if not present:
        return [NAN] * len(raw)
    if all(_INT.match(v) for v in present):
        if any(na):
            return [NAN if n else float(int(v)) for v, n in zip(raw, na)]
        return [int(v) for v in raw]
    if all(_FLOAT.match(v) for v in present):
        return [NAN if n else float(v.strip()) for v, n in zip(raw, na)]
    if all(v in _TRUE or v in _FALSE for v in present):
        return [NAN if n else v in _TRUE for v, n in zip(raw, na)]
    return [NAN if n else v for v, n in zip(raw, na)]


def read_csv(path: str | Path, *, str_columns: Iterable[str] = ()) -> Rows:
    """Read a CSV file (gzip-compressed when ``path`` ends in ``.gz``) as
    ``pd.read_csv(path, dtype={c: str for c in str_columns})`` does (see
    the module docstring). A row with more
    fields than the header raises ``ValueError`` (pandas would take the
    extra leading field as the index); a shorter one is padded with NaN."""
    _raise_field_limit()
    # a ``.gz`` path is gzip-compressed, as pandas infers from the suffix
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", newline="", encoding="utf-8-sig") as f:
        records = [r for r in csv.reader(f) if r]
    if not records:
        raise ValueError(f"{path}: no columns to parse")
    columns = _header(records[0])
    width = len(columns)
    body = records[1:]
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, "
                             f"the header {width}")
    as_str = set(str_columns)
    cols = [_csv_column([r[j] if j < len(r) else None for r in body],
                        name in as_str) for j, name in enumerate(columns)]
    return Rows((dict(zip(columns, vals)) for vals in zip(*cols)), columns) \
        if body else Rows([], columns)


_MISSING = object()


def _json_column(values: list) -> list:
    """One column as ``pd.read_json`` types it: the frame constructor's
    inference, then ``Parser._try_convert_data`` (numeric strings to
    float64, then int64 where that loses nothing)."""
    vals = [NAN if v is _MISSING else v for v in values]
    present = [v for v in vals if not isna(v)]
    nulls = len(present) < len(vals)
    numbers = (int, float)
    if not present:
        return vals                                        # object: None, NaN
    if all(isinstance(v, bool) for v in present) and not nulls:
        return vals                                        # bool
    if all(isinstance(v, numbers) and not isinstance(v, bool)
           for v in present):
        if nulls or any(isinstance(v, float) for v in present):
            data = [NAN if isna(v) else float(v) for v in vals]   # float64
        else:
            return vals                                    # int64
        kind = "float"
    elif all(isinstance(v, str) for v in present):
        data = [NAN if isna(v) else v for v in vals]       # strings
        try:
            data = [NAN if isna(v) else float(v) for v in data]
        except ValueError:
            return data
        kind = "float"
    else:
        data, kind = vals, "object"
    # coerce ints where nothing is lost (a NaN or None blocks it)
    if kind in ("float", "object") and data:
        try:
            ints = [int(v) for v in vals]
        except (TypeError, ValueError, OverflowError):
            return data
        if all(a == b for a, b in zip(ints, data)):
            return ints
    return data


def read_json(path: str | Path, *, lines: bool = False) -> Rows:
    """Read a JSON array of objects (or, with ``lines``, one object a line)
    as ``pd.read_json`` does (see the module docstring)."""
    with open(path, encoding="utf-8") as f:
        if lines:
            objs = [json.loads(line) for line in f if line.strip()]
        else:
            objs = json.load(f)
    if not isinstance(objs, list) or not all(isinstance(o, dict) for o in objs):
        raise ValueError(f"{path}: expected JSON objects, one per row")
    columns: dict[str, None] = {}
    for o in objs:
        columns.update(dict.fromkeys(o))
    cols = [_json_column([o.get(c, _MISSING) for o in objs]) for c in columns]
    return Rows((dict(zip(columns, vals)) for vals in zip(*cols)),
                list(columns)) if objs else Rows([], list(columns))


def _csv_text(value: Any) -> str:
    return "" if isna(value) else str(value)


def write_csv(path: str | Path, rows: Rows) -> bytes:
    """The bytes ``DataFrame.to_csv(path)`` writes for ``rows`` (a leading
    unnamed index column of the row labels, NaN as an empty field), written
    to ``path`` sideways and moved into place. Returns the bytes."""
    import io

    from deepdfa_tpu_torch.resilience.journal import atomic_write_bytes

    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow([""] + rows.columns)
    for label, row in zip(rows.index, rows):
        writer.writerow([_csv_text(label)]
                        + [_csv_text(row[c]) for c in rows.columns])
    data = buf.getvalue().encode("utf-8")
    atomic_write_bytes(path, data)
    return data
