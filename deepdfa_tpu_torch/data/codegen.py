"""Synthetic C source corpus with known vulnerable lines.

A copy of ``deepdfa_tpu/data/codegen.py`` without pandas: template-based
C functions whose vulnerable variants hold a memory-safety defect on a
known line (an unbounded ``strcpy``/``memcpy`` bound), the fixed variants
bound it. The same ``numpy`` generator state gives the JAX package's rows,
text for text. Each row is a plain dict ``{id, before, after, vul,
removed, added}``; :func:`demo_corpus` adds the ``dataset`` name, as the
JAX package's DataFrame column.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["generate_function", "generate_hard_function", "demo_corpus"]


def _names(rng: np.random.Generator, n: int) -> list[str]:
    pool = ["acc", "buf", "cnt", "idx", "len", "out", "ptr", "sum", "tmp", "val"]
    picks = rng.choice(len(pool), size=n, replace=False)
    return [pool[i] + str(int(rng.integers(0, 100))) for i in picks]


def generate_function(fid: int, vul: bool, rng: np.random.Generator) -> dict:
    """One (before, after) pair. Vulnerable: the ``before`` body copies into a
    fixed buffer without a bound; the ``after`` adds the bound — so ``removed``
    (the vul lines) and ``added`` mirror a real security patch's diff."""
    a, b, c = _names(rng, 3)
    k1, k2 = int(rng.integers(1, 9)), int(rng.integers(16, 64))
    filler_pool = [
        f"    int {a} = {c}[0] + {k1};",
        f"    int {b} = {a} * {k1};",
        f"    if ({a} > {k1}) {{ {b} = {a} - 1; }}",
        f"    for (int i = 0; i < {k1}; i++) {{ {b} += i; }}",
    ]
    n_filler = int(rng.integers(1, len(filler_pool) + 1))
    filler = [filler_pool[i] for i in sorted(rng.choice(len(filler_pool), n_filler, replace=False))]

    head = f"int f{fid}(char *{c}, int n)"
    # The defect must be visible to *abstract dataflow*: features come from
    # definitions only (assignments), so the vulnerable copy bound is an
    # unchecked strlen-derived def, the fixed one a clamped arithmetic def —
    # distinct (api, operator) subkeys, like real taint-vs-sanitized code.
    vul_lines = [
        f"    int cap{fid} = strlen({c});",
        f"    memcpy(dst{fid}, {c}, cap{fid});",
    ]
    safe_lines = [
        f"    int cap{fid} = (n < {k2}) ? n : {k2} - 1;",
        f"    memcpy(dst{fid}, {c}, cap{fid});",
    ]
    decl = f"    char dst{fid}[{k2}];"

    def render(mid: list[str]) -> str:
        return "\n".join([head, "{", decl, *filler, *mid, f"    return n + {k1};", "}"])

    before = render(vul_lines if vul else safe_lines)
    after = render(safe_lines)
    if vul:
        # the unchecked-bound def line in `before` (1-based: header, "{",
        # decl, fillers, then the strlen def)
        removed = [3 + len(filler) + 1]
        added = [3 + len(filler) + 1]  # the clamped def replaces it in `after`
    else:
        removed, added = [], []
    return {
        "id": fid,
        "before": before,
        "after": after,
        "vul": int(vul),
        "removed": removed,
        "added": added,
    }


def generate_hard_function(
    fid: int, vul: bool, rng: np.random.Generator, chain_depth: int | None = None
) -> dict:
    """A *dataflow-hard* (before, after) pair: both classes are built from the
    SAME statement multiset — identical per-node abstract-dataflow features,
    identical token histogram — and differ ONLY in the CFG order of two
    statements:

        T:  ``cap = strlen(src);``              (tainted bound)
        C:  ``if (cap >= K) { cap = K - 1; }``  (clamp)

    safe order ``T;C``  → the clamp dominates the copy: IN(memcpy) ∋ clamp def
    vul order  ``C;T``  → the taint re-defines cap after the clamp:
                          IN(memcpy) = {taint def} only

    So the class is a function of *which definition reaches the copy* — pure
    reaching-definitions reasoning (the reference's learned-DFA thesis,
    ``clipper.py:50-77``); any bag-of-features classifier is at chance by
    construction. A random 0-8 statement gap between the clamp/taint block
    and the copy stretches the def→use chains past a fixed message-passing
    depth for some functions, keeping the task nontrivial for the GGNN too.

    The patch (``after``) restores the safe order, so ``removed``/``added``
    line labels mirror a real reordering fix.

    ``chain_depth=L`` switches to the **depth-controlled** variant (the
    union-vs-sum separation corpus, round-3): the two defs are separated by
    exactly ``L`` branch-merge statements over unrelated variables, and the
    copy follows immediately after the second def. Around every statement the
    two classes are locally identical (same taint, same clamp, same gap
    multiset); telling WHICH def comes last — i.e. which one reaches the
    ``memcpy`` — requires integrating order information across ≥ L CFG hops.
    Each gap ``if`` is a reconvergent diamond, so defs re-arrive along
    multiple paths: a sum aggregator accumulates path-multiplicity counts
    while an idempotent union (a∪a=a, the RD lattice meet) does not — the
    regime where the reference's differentiable-DFA aggregator
    (``clipper.py:50-77``) should earn its keep.
    """
    a, b, c = _names(rng, 3)
    k1 = int(rng.integers(2, 9))
    k2 = int(rng.integers(16, 64))
    cap = f"cap{fid}"

    taint = f"    {cap} = (int)strlen({c});"
    clamp = f"    if ({cap} >= {k2}) {{ {cap} = {k2} - 1; }}"

    if chain_depth is None:
        gap_pool = [
            f"    int {a} = {k1};",
            f"    int {b} = {a} + {k1};" if rng.random() < 0.5 else f"    int {b} = {k1} * 2;",
            f"    if ({a} > {k1}) {{ {a} = {a} - 1; }}",
            f"    for (int i = 0; i < {k1}; i++) {{ {b} += i; }}",
            f"    {b} = {b} ^ {a};",
            f"    while ({a} > 0) {{ {a} -= 1; }}",
            f"    {a} = {a} + {b};",
            f"    if ({b} > {a}) {{ {b} = {a}; }}",
        ]
        n_gap = int(rng.integers(0, 9))
        gap = [gap_pool[i] for i in sorted(rng.choice(len(gap_pool), min(n_gap, len(gap_pool)), replace=False))]
        between: list[str] = []
    else:
        # L branch-merge diamonds BETWEEN the defs; nothing after the second
        # def, so receptive-field distance to the copy is exactly the chain.
        between = [
            f"    if ({a} > {int(rng.integers(0, 99))}) {{ {b} = {b} + {i}; }}"
            for i in range(chain_depth)
        ]
        gap = []

    head = f"int f{fid}(char *{c}, int n)"
    decl = [f"    char dst{fid}[{k2}];", f"    int {cap} = 0;",
            f"    int {a} = n; int {b} = {k1};"] if chain_depth is not None else [
            f"    char dst{fid}[{k2}];", f"    int {cap} = 0;"]
    copy = f"    memcpy(dst{fid}, {c}, {cap});"
    tail = f"    return {cap};"

    def render(first: str, second: str) -> str:
        return "\n".join(
            [head, "{", *decl, first, *between, second, *gap, copy, tail, "}"]
        )

    before = render(clamp, taint) if vul else render(taint, clamp)
    after = render(taint, clamp)
    n_decl = len(decl)
    if vul:
        # 1-based: head, "{", decls, first def, between..., second def (taint)
        taint_line_before = 2 + n_decl + 1 + len(between) + 1
        copy_line = taint_line_before + len(gap) + 1
        removed = [taint_line_before, copy_line]
        added = [2 + n_decl + 1]  # taint moved before the clamp in `after`
    else:
        removed, added = [], []
    return {
        "id": fid,
        "before": before,
        "after": after,
        "vul": int(vul),
        "removed": removed,
        "added": added,
    }


def demo_corpus(
    n: int = 200,
    vul_ratio: float = 0.5,
    seed: int = 0,
    style: str = "easy",
    chain_depth: int | None = None,
) -> list[dict]:
    """A balanced-ish labeled corpus: ``n`` rows of :func:`generate_function`
    (``style="easy"``, dataset ``demo``), :func:`generate_hard_function`
    (``style="hard"``, ``demo_hard``) or its depth-controlled variant
    (``chain_depth=L``, ``demo_order{L}``), each row carrying its
    ``dataset`` name. The JAX package's DataFrame's ``to_dict("records")``,
    row for row."""
    rng = np.random.default_rng(seed)
    if chain_depth is not None:
        gen = functools.partial(generate_hard_function, chain_depth=chain_depth)
        dataset = f"demo_order{chain_depth}"
    elif style == "hard":
        gen, dataset = generate_hard_function, "demo_hard"
    else:
        gen, dataset = generate_function, "demo"
    rows = [gen(fid, bool(rng.random() < vul_ratio), rng) for fid in range(n)]
    return [{**row, "dataset": dataset} for row in rows]
