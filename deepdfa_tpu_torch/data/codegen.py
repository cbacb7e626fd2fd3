"""Synthetic C source corpus with known vulnerable lines.

A copy of ``generate_function`` and ``generate_hard_function`` of
``deepdfa_tpu/data/codegen.py``: template-based C functions whose
vulnerable variants hold a memory-safety defect on a known line (an
unbounded ``strcpy``/``memcpy`` bound), the fixed variants bound it. The
same ``numpy`` generator state gives the JAX package's rows, text for
text. Each row is a plain dict ``{id, before, after, vul, removed,
added}``; the JAX package's ``demo_corpus`` DataFrame waits for the ingest
slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_function", "generate_hard_function"]


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


def generate_hard_function(fid: int, vul: bool, rng: np.random.Generator) -> dict:
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
    reaching-definitions reasoning; any bag-of-features classifier is at
    chance by construction. A random 0-8 statement gap between the
    clamp/taint block and the copy stretches the def→use chains past a fixed
    message-passing depth for some functions.

    The patch (``after``) restores the safe order, so ``removed``/``added``
    line labels mirror a real reordering fix. (The JAX package's
    ``chain_depth`` variant waits for a caller.)
    """
    a, b, c = _names(rng, 3)
    k1 = int(rng.integers(2, 9))
    k2 = int(rng.integers(16, 64))
    cap = f"cap{fid}"

    taint = f"    {cap} = (int)strlen({c});"
    clamp = f"    if ({cap} >= {k2}) {{ {cap} = {k2} - 1; }}"
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

    head = f"int f{fid}(char *{c}, int n)"
    decl = [f"    char dst{fid}[{k2}];", f"    int {cap} = 0;"]
    copy = f"    memcpy(dst{fid}, {c}, {cap});"
    tail = f"    return {cap};"

    def render(first: str, second: str) -> str:
        return "\n".join([head, "{", *decl, first, second, *gap, copy, tail, "}"])

    before = render(clamp, taint) if vul else render(taint, clamp)
    after = render(taint, clamp)
    if vul:
        # 1-based: head, "{", decls, first def, second def (taint)
        taint_line_before = 2 + len(decl) + 2
        removed = [taint_line_before, taint_line_before + len(gap) + 1]
        added = [2 + len(decl) + 1]  # taint moved before the clamp in `after`
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
