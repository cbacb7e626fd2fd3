"""CPG / CFG visualization as Graphviz DOT text.

A copy of ``deepdfa_tpu/cpg/plot.py``, text for text.
The reference shipped a graphviz plotting path that was broken at import
(``DDFA/sastvd/helpers/joern.py:5`` — commented-out import, dead
``plot_graph_node_edge_df`` surface). This emits plain DOT text instead: no
graphviz binary or python binding required to *produce* the artifact, and
any ``dot``/online viewer renders it. Optional reaching-definitions overlay
annotates each node with its solver OUT set, which is the debugging view the
learned-DFA experiments actually need.
"""

from __future__ import annotations

from pathlib import Path

from deepdfa_tpu_torch.cpg.schema import CPG, RDG_ETYPES, rdg
from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = ["to_dot", "write_dot"]

_ETYPE_STYLE = {
    "CFG": ("solid", "black"),
    "AST": ("dotted", "gray50"),
    "REACHING_DEF": ("dashed", "blue"),
    "CDG": ("dashed", "red"),
    "DDG": ("dashed", "forestgreen"),
    "REF": ("dotted", "purple"),
    "ARGUMENT": ("dotted", "gray70"),
}


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def to_dot(
    cpg: CPG,
    gtype: str = "all",
    rd_out: dict[int, set] | None = None,
    max_code_chars: int = 40,
) -> str:
    """Render the ``gtype`` subgraph (``rdg`` etype selection, same keys as
    the training materializer) as DOT. ``rd_out``: optional node → set of
    reaching definitions (e.g. from ``ReachingDefinitions(cpg).solve()[1]``)
    appended to each node label as ``RD:{var@line,...}``."""
    edges = rdg(cpg, gtype)  # validates gtype
    etypes = RDG_ETYPES[gtype]
    # only endpoints that exist in the node table: a malformed export row
    # must not make Graphviz auto-create bare nodes
    keep = ({s for s, _ in edges} | {d for _, d in edges}) & set(cpg.nodes)
    lines = [
        "digraph cpg {",
        '  node [shape=box, fontname="monospace", fontsize=9];',
        '  edge [fontsize=8];',
    ]
    for nid in sorted(keep):
        n = cpg.nodes[nid]  # keep ⊆ cpg.nodes by construction above
        code = n.code[:max_code_chars] + ("…" if len(n.code) > max_code_chars else "")
        label = f"{nid} {n.label}"
        if n.line is not None:
            label += f" L{n.line}"
        if code:
            label += f"\n{code}"
        if rd_out is not None and rd_out.get(nid):
            def _def_label(d) -> str:
                # VariableDefinition(var, node, ...) — line comes from the
                # defining node; fall back to repr for foreign set elements
                dn = cpg.nodes.get(getattr(d, "node", -1))
                if hasattr(d, "var"):
                    line = dn.line if dn is not None and dn.line is not None else "?"
                    return f"{d.var}@{line}"
                return str(d)

            defs = sorted(_def_label(d) for d in rd_out[nid])
            label += "\nRD:{" + ",".join(defs) + "}"
        lines.append(f'  n{nid} [label="{_esc(label)}"];')
    for s, d, e in cpg.edges:
        if e not in etypes or s not in keep or d not in keep:
            continue
        style, color = _ETYPE_STYLE.get(e, ("solid", "gray30"))
        lines.append(
            f'  n{s} -> n{d} [style={style}, color={color}, label="{_esc(e)}"];'
        )
    lines.append("}")
    return "\n".join(lines) + "\n"


def write_dot(cpg: CPG, path: str | Path, **kwargs) -> Path:
    path = Path(path)
    atomic_write_text(path, to_dot(cpg, **kwargs), encoding="utf-8")
    return path
