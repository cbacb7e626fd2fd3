"""Joern artifact ingestion + offline runner.

A copy of ``deepdfa_tpu/cpg/joern.py`` without pandas. Readers for the
three per-function artifacts the reference's Joern script exports
(``DDFA/storage/external/get_func_graph.sc:49-75``):

- ``{f}.nodes.json`` — list of node property dicts;
- ``{f}.edges.json`` — list of ``[innode, outnode, etype, variable]`` rows
  (Joern edge: outNode → inNode, so src=outnode);
- ``{f}.dataflow.json`` — per-method ``problem.gen/problem.kill/
  solution.in/solution.out`` maps (node id → list of def node ids).

The tables are row dicts with pandas' values: :func:`read_raw` fills a
missing cell with ``""`` (``fillna("")``), :func:`load_tables` turns the
line and endpoint columns into numbers as ``pd.to_numeric(errors=
"coerce")`` does (NaN where a cell is not one, every cell of a column
that holds a NaN or a float a float) and keeps the first of repeated
``(innode, outnode, etype)`` edges. :func:`load_cpg` follows the
reference's analysis-side cleanup (``code_gnn/analysis/dataflow.py:
201-250``): nodes with line numbers, no dangling edges, no lone nodes.

:class:`JoernRunner` shells out to a local joern install (the reference
pinned v1.1.107); the native front end (:mod:`deepdfa_tpu_torch.cpg.
frontend`) is the hermetic default.
"""

from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path

from deepdfa_tpu_torch.cpg.schema import CPG
from deepdfa_tpu_torch.data.table import NAN, isna
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = [
    "read_raw", "load_tables", "load_cpg", "load_dataflow",
    "reexport_dataflow", "JoernRunner",
]

NODE_COLUMNS = [
    "id", "_label", "name", "code", "lineNumber", "columnNumber",
    "lineNumberEnd", "columnNumberEnd", "controlStructureType", "order",
    "fullName", "typeFullName",
]
EDGE_COLUMNS = ["innode", "outnode", "etype", "dataflow"]

# Edge types that are bookkeeping, not program structure.
DROP_ETYPES = {"CONTAINS", "SOURCE_FILE", "DOMINATE", "POST_DOMINATE"}
DROP_LABELS = {"COMMENT", "FILE"}


def _filled(value):
    return "" if isna(value) else value


def read_raw(stem: str | Path) -> tuple[list[dict], list[dict]]:
    """``{stem}.nodes.json`` / ``{stem}.edges.json`` as raw row tables
    (node rows keyed by :data:`NODE_COLUMNS`, edge rows by
    :data:`EDGE_COLUMNS`), a missing cell ``""``."""
    stem = str(stem)
    with open(stem + ".edges.json") as f:
        edges = [{c: _filled(e[i] if i < len(e) else None)
                  for i, c in enumerate(EDGE_COLUMNS)} for e in json.load(f)]
    with open(stem + ".nodes.json") as f:
        nodes = [{c: _filled(n.get(c)) for c in NODE_COLUMNS}
                 for n in json.load(f)]
    return nodes, edges


def _to_number(value):
    """One cell of ``pd.to_numeric(errors="coerce")``: a number, or NaN."""
    if isinstance(value, bool) or isna(value):
        return NAN
    if isinstance(value, (int, float)):
        return value
    try:
        return int(value)
    except (TypeError, ValueError):
        pass
    try:
        return float(value)
    except (TypeError, ValueError):
        return NAN


def _numeric(rows: list[dict], col: str) -> None:
    """``df[col] = pd.to_numeric(df[col], errors="coerce")``, in place."""
    vals = [_to_number(r[col]) for r in rows]
    if any(isinstance(v, float) for v in vals):
        vals = [float(v) for v in vals]
    for r, v in zip(rows, vals):
        r[col] = v


def load_tables(stem: str | Path) -> tuple[list[dict], list[dict]]:
    """ML-side tables: filtered labels/etypes, numeric lines, deduped
    edges."""
    nodes, edges = read_raw(stem)
    if not any(n["_label"] == "METHOD" for n in nodes):
        raise ValueError(f"{stem}: graph has no METHOD node")
    nodes = [n for n in nodes if n["_label"] not in DROP_LABELS]
    edges = [e for e in edges if e["etype"] not in DROP_ETYPES]
    for n in nodes:
        if n["code"] == "<empty>":
            n["code"] = ""
        if n["code"] == "":
            n["code"] = n["name"]
    _numeric(nodes, "lineNumber")
    _numeric(edges, "innode")
    _numeric(edges, "outnode")
    kept, seen = [], set()
    for e in edges:
        if isna(e["innode"]) or isna(e["outnode"]):
            continue
        e["innode"], e["outnode"] = int(e["innode"]), int(e["outnode"])
        key = (e["innode"], e["outnode"], e["etype"])
        if key not in seen:
            seen.add(key)
            kept.append(e)
    return nodes, kept


def load_cpg(stem: str | Path) -> CPG:
    """Analysis-side CPG (reaching definitions, abstract dataflow): nodes with
    line numbers, dangling edges dropped, no lone nodes."""
    nodes, edges = load_tables(stem)
    nodes = [dict(n, lineNumber=int(n["lineNumber"])) for n in nodes
             if not isna(n["lineNumber"])]
    ids = {int(n["id"]) for n in nodes}
    edges = [e for e in edges if e["innode"] in ids and e["outnode"] in ids]
    connected = {e["innode"] for e in edges} | {e["outnode"] for e in edges}
    nodes = [n for n in nodes if n["id"] in connected]
    return CPG.from_tables(nodes, edges)


def load_dataflow(path: str | Path) -> dict:
    """Parse ``{f}.dataflow.json`` → {method: {key: {node_id: [def ids]}}}
    with int keys (reference loader: ``helpers/datasets.py:780-796``)."""
    with open(str(path)) as f:
        raw = json.load(f)
    out: dict = {}
    for method, solution in raw.items():
        out[method] = {
            key: {int(k): [int(v) for v in vs] for k, vs in mapping.items()}
            for key, mapping in solution.items()
        }
    return out


def reexport_dataflow(stem: str | Path, cache: bool = True) -> Path:
    """Summary-cached dataflow re-export with the native solver (parity with
    ``DDFA/storage/external/get_dataflow_output.sc:26-75``): re-run
    reaching definitions over the cached ``{stem}.nodes.json``/
    ``.edges.json`` (no re-extraction, no JVM) and (re)write
    ``{stem}.dataflow.json`` in the reference schema, then the
    ``{stem}.dataflow.summary.json`` marker. With the marker present and
    ``cache=True`` the call is a no-op. The Joern-path twin is
    ``cpg/queries/reexport_dataflow.sc``.
    """
    from deepdfa_tpu_torch.cpg.dataflow import ReachingDefinitions

    stem = str(stem)
    out_path = Path(stem + ".dataflow.json")
    summary_path = Path(stem + ".dataflow.summary.json")
    if cache and summary_path.exists():
        return out_path

    cpg = load_cpg(stem)
    rd = ReachingDefinitions(cpg)
    in_sets, out_sets = rd.solve()
    methods = [
        n for n in cpg.nodes.values()
        if n.label == "METHOD" and n.name not in ("<global>", "<empty>", "")
    ]

    def ast_descendants(root: int) -> set[int]:
        seen, work = {root}, [root]
        while work:
            for c in cpg.successors(work.pop(), "AST"):
                if c not in seen:
                    seen.add(c)
                    work.append(c)
        return seen

    # per-method sets, like the Joern twin's per-method ReachingDefProblem:
    # a multi-method artifact must not attribute one function's
    # definitions to another
    member: dict[str, set[int]] | None = None
    if len(methods) > 1:
        member = {m.name: ast_descendants(m.id) for m in methods}

    def node_sets(sets_by_node: dict[int, set],
                  keep: set[int] | None) -> dict[str, list[int]]:
        return {
            str(n): sorted(d.node for d in s)
            for n, s in sorted(sets_by_node.items())
            if keep is None or n in keep
        }

    gen = {n: s for n, s in rd.gen.items() if s}
    kill = {n: rd.kill(n, rd.domain) for n in gen}
    per_method = {}
    for m in methods or [None]:
        name = m.name if m is not None else Path(stem).stem
        keep = member.get(name) if (member and m is not None) else None
        per_method[name] = {
            "problem.gen": node_sets(gen, keep),
            "problem.kill": node_sets(kill, keep),
            "solution.in": node_sets(in_sets, keep),
            "solution.out": node_sets(out_sets, keep),
        }
    atomic_write_text(out_path, json.dumps(per_method))
    atomic_write_text(summary_path, json.dumps({
        "methods": len(per_method),
        "solved_nodes": {k: len(v["solution.in"]) for k, v in per_method.items()},
        "domain_size": len(rd.domain),
        "solver": "native",
    }))
    return out_path


class JoernRunner:
    """Batch runner for a local joern install (optional path).

    One-shot invocation per file, parity with ``helpers/joern.py:162-179``:
    ``joern --script export_func_graph.sc --params filename=...``. Exports
    land next to the source file; a re-run is skipped when the artifacts
    exist (``get_func_graph.sc:36-48``).
    """

    def __init__(self, script: str | Path | None = None, joern_bin: str = "joern"):
        if script is None:  # the package ships its own query script
            script = Path(__file__).parent / "queries" / "export_func_graph.sc"
        self.script = Path(script)
        self.joern_bin = joern_bin

    @property
    def available(self) -> bool:
        return shutil.which(self.joern_bin) is not None

    def run(self, c_file: str | Path, timeout: int = 600) -> Path:
        c_file = Path(c_file)
        stem = str(c_file)
        if Path(stem + ".nodes.json").exists() and Path(stem + ".edges.json").exists():
            return c_file
        if not self.available:
            raise RuntimeError(
                f"joern binary {self.joern_bin!r} not on PATH; use the native "
                "frontend (deepdfa_tpu_torch.cpg.frontend) or install joern"
            )
        subprocess.run(
            [self.joern_bin, "--script", str(self.script), "--params", f"filename={stem}"],
            check=True,
            timeout=timeout,
            capture_output=True,
        )
        return c_file

    def reexport_dataflow(self, c_file: str | Path, cache: bool = True,
                          timeout: int = 600) -> Path:
        """JVM-path summary-cached re-solve over the cached ``.cpg.bin``
        (``queries/reexport_dataflow.sc``; reference:
        ``get_dataflow_output.sc:26-75``). Prefer the module-level
        :func:`reexport_dataflow` (native solver, no JVM) unless Joern's own
        solver output is required."""
        if not self.available:
            raise RuntimeError(
                f"joern binary {self.joern_bin!r} not on PATH; use the native "
                "reexport_dataflow (deepdfa_tpu_torch.cpg.joern) instead"
            )
        stem = str(Path(c_file))
        script = Path(__file__).parent / "queries" / "reexport_dataflow.sc"
        params = f"filename={stem},cache={'true' if cache else 'false'}"
        subprocess.run(
            [self.joern_bin, "--script", str(script), "--params", params],
            check=True, timeout=timeout, capture_output=True,
        )
        return Path(stem + ".dataflow.json")
