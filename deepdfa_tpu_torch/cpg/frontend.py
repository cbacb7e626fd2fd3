"""Native C front end: C source → Joern-compatible CPG, no JVM.

A copy of ``deepdfa_tpu/cpg/frontend.py``: the same pycparser lowering,
node for node and id for id, so both packages build the same CPG from the
same source. Output contract (what the reaching-definitions solvers and
the abstract-dataflow extractor consume):

- node labels: METHOD, METHOD_PARAMETER_IN, METHOD_RETURN, BLOCK, LOCAL,
  CALL, IDENTIFIER, LITERAL, CONTROL_STRUCTURE, RETURN, JUMP_TARGET;
- operator calls named in Joern's ``<operator>.*`` vocabulary (assignment
  family, inc/dec, arithmetic, comparisons, indexAccess, fieldAccess /
  indirectFieldAccess, indirection, addressOf, cast, conditional);
- ``AST`` edges parent→child, ``ARGUMENT`` edges call→operand (``order``
  1-based), ``CFG`` edges in evaluation order — branch-sensitive: the
  ternary operator and short-circuiting ``&&``/``||`` fork the CFG like
  ``if`` does;
- IDENTIFIER/LOCAL/METHOD_PARAMETER_IN nodes carry ``typeFullName``
  resolved from the local scope, arrays rendered ``T[n]``, pointers
  ``T *``.

Deviation from Joern, by design: the CFG chains only call-level nodes
(operator/function calls, plus METHOD / RETURN / JUMP_TARGET /
METHOD_RETURN) rather than every leaf expression; reaching definitions are
unaffected while graphs shrink about 2x.

C is parsed after a lightweight in-process preprocess: comments and
``#``-directives are stripped; unknown typedef'd types are recovered by (a)
a pre-pass typedefing statement-initial ``X *y`` declarations, and (b)
iteratively inserting ``typedef int X;`` on parse errors.

CFG lowering protocol: every expression/statement lowers to a fragment
``(entries, exits)`` — the CFG nodes control enters through / falls out of.
Transparent constructs (leaves, empty statements) have empty fragments;
sequencing, branching and loops wire fragments together.
"""

from __future__ import annotations

import re

import pycparser
from pycparser import c_ast
from pycparser.c_parser import ParseError

from deepdfa_tpu_torch.cpg.schema import CPG, Node

__all__ = ["parse_function", "parse_functions", "parse_source",
           "strip_comments", "FrontendError"]


class FrontendError(ValueError):
    pass


BINARY_OPS = {
    "+": "addition",
    "-": "subtraction",
    "*": "multiplication",
    "/": "division",
    "%": "modulo",
    "<": "lessThan",
    ">": "greaterThan",
    "<=": "lessEqualsThan",
    ">=": "greaterEqualsThan",
    "==": "equals",
    "!=": "notEquals",
    "&&": "logicalAnd",
    "||": "logicalOr",
    "&": "and",
    "|": "or",
    "^": "xor",
    "<<": "shiftLeft",
    ">>": "arithmeticShiftRight",
}
ASSIGN_OPS = {
    "=": "assignment",
    "+=": "assignmentPlus",
    "-=": "assignmentMinus",
    "*=": "assignmentMultiplication",
    "/=": "assignmentDivision",
    "%=": "assignmentModulo",
    "&=": "assignmentAnd",
    "|=": "assignmentOr",
    "^=": "assignmentXor",
    "<<=": "assignmentShiftLeft",
    ">>=": "assignmentArithmeticShiftRight",
}
UNARY_OPS = {
    "++": "preIncrement",
    "--": "preDecrement",
    "p++": "postIncrement",
    "p--": "postDecrement",
    "*": "indirection",
    "&": "addressOf",
    "-": "minus",
    "+": "plus",
    "!": "logicalNot",
    "~": "not",
    "sizeof": "sizeOf",
}


def strip_comments(code: str) -> str:
    """Remove // and /* */ comments, preserving line numbers (same job as the
    reference's ``remove_comments``, ``helpers/datasets.py:19-33``)."""

    def repl(m):
        s = m.group(0)
        if s.startswith("/"):
            return "\n" * s.count("\n") if s.startswith("/*") else ""
        return s

    pattern = r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\])*\"|'(?:\\.|[^'\\])*'"
    return re.sub(pattern, repl, code, flags=re.DOTALL)


def _blank_span(text: str) -> str:
    """Replace a span with spaces, preserving newlines (and therefore every
    line/column the parser will report)."""
    return "".join(ch if ch == "\n" else " " for ch in text)


def _match_paren(code: str, i: int) -> int | None:
    """Index just past the ``)`` matching the ``(`` at ``i`` — skipping
    parens inside string/char literals (extended asm templates contain
    them, e.g. ``asm("save (" ::: "memory")``)."""
    depth = 0
    k = i
    while k < len(code):
        ch = code[k]
        if ch in "\"'":
            quote = ch
            k += 1
            while k < len(code) and code[k] != quote:
                k += 2 if code[k] == "\\" else 1
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return k + 1
        k += 1
    return None


def _scrub_kw_parens(code: str, keyword_re: re.Pattern, repl: str) -> str:
    """Blank every ``keyword (...balanced...)`` construct, substituting
    ``repl`` at the keyword position (length-padded)."""
    out = []
    pos = 0
    while True:
        m = keyword_re.search(code, pos)
        if not m:
            out.append(code[pos:])
            return "".join(out)
        i = code.find("(", m.end() - 1)
        j = _match_paren(code, i) if i >= 0 else None
        if i < 0 or j is None:  # unbalanced — leave for the parser to report
            out.append(code[pos:m.end()])
            pos = m.end()
            continue
        span = code[m.start():j]
        blanked = _blank_span(span)
        out.append(code[pos:m.start()])
        out.append(repl + blanked[len(repl):] if len(repl) <= len(blanked) else repl)
        pos = j


_ATTR_RE = re.compile(r"\b__attribute__\s*(?=\()")
_ASM_RE = re.compile(r"\b(?:__asm__|__asm|asm)\b\s*(?:__volatile__|volatile)?\s*(?=\()")
_TYPEOF_RE = re.compile(r"\b(?:__typeof__|__typeof|typeof)\s*(?=\()")
# GNU spelling → standard spelling, length-padded so columns survive
_GNU_TOKEN_MAP = [
    (re.compile(r"\b__restrict__\b"), "restrict"),
    (re.compile(r"\b__restrict\b"), "restrict"),
    (re.compile(r"\b__inline__\b"), "inline"),
    (re.compile(r"\b__inline\b"), "inline"),
    (re.compile(r"\b__volatile__\b"), "volatile"),
    (re.compile(r"\b__signed__\b"), "signed"),
    (re.compile(r"\b__const\b"), "const"),
    (re.compile(r"\b__extension__\b"), ""),
]
_CASE_RANGE_RE = re.compile(r"(\bcase\b[^:\n]*?)\.\.\.[^:\n]*(:)")
_GENERIC_RE = re.compile(r"\b_Generic\s*(?=\()")
# `goto *expr;` — dynamic target, statically unresolvable even for Joern;
# degraded to an empty statement (the labels themselves parse fine)
_COMPUTED_GOTO_RE = re.compile(r"\bgoto\s*\*[^;\n]*;")
# address-of-label `&&lbl` in unary position ONLY: immediately after = ( ,
# { ? : (brace-initialized label tables, ternary arms) or `return` —
# anywhere else `&&` is the binary operator and must survive
_ADDR_LABEL_RE = re.compile(r"([=(,{?:]\s*|\breturn\s+)&&\s*\w+")
# digraphs are alternative spellings of { } [ ] (C11 6.4.6); replace outside
# string/char literals, column-padded
_DIGRAPH_OR_LITERAL_RE = re.compile(
    r"\"(?:\\.|[^\"\\])*\"|'(?:\\.|[^'\\])*'|<%|%>|<:|:>"
)
_DIGRAPH_MAP = {"<%": "{ ", "%>": "} ", "<:": "[ ", ":>": "] "}
# an ALL-CAPS call alone on a line with the block opener on the next line —
# the `LIST_FOREACH(x, list)\n{` shape of statement-like macros; appending a
# `;` turns it into a call statement followed by a plain block, keeping the
# block's statements in the CFG
_MACRO_BLOCK_RE = re.compile(
    r"^([ \t]*[A-Z][A-Z0-9_]*\s*\([^;{}\n]*\))(?=[ \t]*(?:\n\s*)?\{)",
    re.MULTILINE,
)


def _scrub_gnu_extensions(code: str) -> str:
    """Cheap, line/column-preserving scrubs for the constructs a header-less
    Big-Vul-style function actually contains but pycparser cannot eat:
    ``__attribute__((...))``, (extended) asm, ``typeof(x)`` (degraded to
    ``int`` — extraction cares about the CFG/def-use shape, not the inferred
    type), GNU keyword spellings, ``case a ... b:`` ranges, and statement
    macros that open a block. Everything is blanked with spaces, never
    removed, so parser positions keep pointing at the original source."""
    code = _scrub_kw_parens(code, _ATTR_RE, "")
    code = _scrub_kw_parens(code, _ASM_RE, "")
    code = _scrub_kw_parens(code, _TYPEOF_RE, "int")
    # `_Generic(...)` selections degrade to 0 — extraction cares about the
    # CFG/def-use shape, not the type-dispatched value
    code = _scrub_kw_parens(code, _GENERIC_RE, "0")
    code = _DIGRAPH_OR_LITERAL_RE.sub(
        lambda m: _DIGRAPH_MAP.get(m.group(0), m.group(0)), code
    )
    code = _COMPUTED_GOTO_RE.sub(
        lambda m: _blank_span(m.group(0)[:-1]) + ";", code
    )
    code = _ADDR_LABEL_RE.sub(
        lambda m: m.group(1) + "0" + " " * (len(m.group(0)) - len(m.group(1)) - 1),
        code,
    )
    for pat, repl in _GNU_TOKEN_MAP:
        code = pat.sub(lambda m, r=repl: r + " " * (len(m.group(0)) - len(r)), code)
    code = _CASE_RANGE_RE.sub(
        lambda m: m.group(1) + " " * (len(m.group(0)) - len(m.group(1)) - 1) + m.group(2),
        code,
    )
    code = _MACRO_BLOCK_RE.sub(lambda m: m.group(1) + ";", code)
    return code


def _preprocess(code: str) -> str:
    code = strip_comments(code)
    lines = []
    for ln in code.split("\n"):
        if ln.lstrip().startswith("#"):
            lines.append("")  # keep line numbering
        else:
            lines.append(ln)
    return _scrub_gnu_extensions("\n".join(lines))


_PARSE_ERR_RE = re.compile(r":(\d+):(\d+): before: (\S+)")

_C_KEYWORDS = frozenset(
    "auto break case char const continue default do double else enum extern "
    "float for goto if inline int long register restrict return short signed "
    "sizeof static struct switch typedef union unsigned void volatile while".split()
)
_BUILTIN_TYPE_WORDS = _C_KEYWORDS | {"ANY"}
# identifier followed by (pointer stars and) another identifier then a
# declarator-ish delimiter — the `X y,` / `X *y)` shape of a typedef'd type
_TYPEISH_RE = re.compile(
    r"\b([A-Za-z_]\w*)(?:\s+\*{0,3}\s*|\s*\*{1,3}\s*)[A-Za-z_]\w*\s*[,)=;[]"
)
# statement-initial `X *y = ...` / `X *y;`: C resolves this ambiguity as a
# declaration, so X must be a type — but pycparser happily parses it as
# multiplication when X is an unknown typedef name, silently corrupting the
# graph. Typedef these proactively before the first parse.
_DECL_PTR_RE = re.compile(
    r"(?:^|[;{}])\s*([A-Za-z_]\w*)\s*\*+\s*[A-Za-z_]\w*\s*[=;,[]", re.MULTILINE
)


def _unknown_type_candidate(source: str, err: ParseError) -> str | None:
    """pycparser reports the token *after* an unknown type name
    (``size_t n`` errors at ``n``); recover the identifier immediately
    preceding the error position."""
    m = _PARSE_ERR_RE.search(str(err))
    if not m:
        return None
    line_no, col, _tok = int(m.group(1)), int(m.group(2)), m.group(3)
    lines = source.split("\n")
    if not (1 <= line_no <= len(lines)):
        return None
    before = lines[line_no - 1][: col - 1]
    im = re.search(r"([A-Za-z_]\w*)\s*\**\s*$", before)
    if not im:
        return None
    cand = im.group(1)
    if cand in _C_KEYWORDS:
        return None
    return cand


def _parse_with_recovery(code: str, max_retries: int = 25):
    """Parse; on unknown-type errors, prepend ``typedef int X;`` and retry
    (bounded). Recovers typedef'd types without real headers. Returns
    (ast, number of typedef lines prepended)."""
    typedefs: list[str] = [
        t
        for t in dict.fromkeys(_DECL_PTR_RE.findall(code))
        if t not in _BUILTIN_TYPE_WORDS
    ]
    used_bulk = False
    last_err = None
    for _ in range(max_retries):
        prefix = "".join(f"typedef int {t};\n" for t in typedefs)
        source = prefix + code
        try:
            return pycparser.CParser().parse(source, "<func>"), len(typedefs)
        except ParseError as e:
            last_err = e
            cand = _unknown_type_candidate(source, e)
            if cand is not None and cand not in typedefs:
                typedefs.append(cand)
                continue
            if not used_bulk:
                # positionless errors ("Invalid declaration"): typedef every
                # type-looking identifier in one shot and retry once
                used_bulk = True
                bulk = [
                    t
                    for t in dict.fromkeys(_TYPEISH_RE.findall(code))
                    if t not in _BUILTIN_TYPE_WORDS and t not in typedefs
                ]
                if bulk:
                    typedefs.extend(bulk)
                    continue
            break
    raise FrontendError(f"cannot parse C source: {last_err}")


def _render_type(node) -> str:
    """Render a pycparser type node to a Joern-ish type string."""
    if isinstance(node, c_ast.TypeDecl):
        quals = " ".join(q for q in node.quals if q != "const")
        base = _render_type(node.type)
        return (quals + " " + base).strip()
    if isinstance(node, c_ast.IdentifierType):
        return " ".join(node.names)
    if isinstance(node, c_ast.PtrDecl):
        return _render_type(node.type) + " *"
    if isinstance(node, c_ast.ArrayDecl):
        dim = ""
        if node.dim is not None and isinstance(node.dim, c_ast.Constant):
            dim = node.dim.value
        return f"{_render_type(node.type)}[{dim}]"
    if isinstance(node, c_ast.Struct):
        return f"struct {node.name or ''}".strip()
    if isinstance(node, c_ast.Union):
        return f"union {node.name or ''}".strip()
    if isinstance(node, c_ast.Enum):
        return f"enum {node.name or ''}".strip()
    if isinstance(node, c_ast.FuncDecl):
        return _render_type(node.type)
    return "ANY"


def _code_of(node) -> str:
    """Best-effort source rendering of an expression subtree."""
    return _CodeGen().visit(node)


class _CodeGen:
    def visit(self, n) -> str:
        if n is None:
            return ""
        meth = getattr(self, "v_" + type(n).__name__, None)
        return meth(n) if meth else "..."

    def v_Constant(self, n):
        return n.value

    def v_ID(self, n):
        return n.name

    def v_ArrayRef(self, n):
        return f"{self.visit(n.name)}[{self.visit(n.subscript)}]"

    def v_StructRef(self, n):
        return f"{self.visit(n.name)}{n.type}{self.visit(n.field)}"

    def v_UnaryOp(self, n):
        if n.op in ("p++", "p--"):
            return f"{self.visit(n.expr)}{n.op[1:]}"
        if n.op == "sizeof":
            return f"sizeof({self.visit(n.expr)})"
        return f"{n.op}{self.visit(n.expr)}"

    def v_BinaryOp(self, n):
        return f"{self.visit(n.left)} {n.op} {self.visit(n.right)}"

    def v_Assignment(self, n):
        return f"{self.visit(n.lvalue)} {n.op} {self.visit(n.rvalue)}"

    def v_FuncCall(self, n):
        args = ", ".join(self.visit(a) for a in (n.args.exprs if n.args else []))
        return f"{self.visit(n.name)}({args})"

    def v_Cast(self, n):
        return f"({_render_type(n.to_type.type)}){self.visit(n.expr)}"

    def v_TernaryOp(self, n):
        return f"{self.visit(n.cond)} ? {self.visit(n.iftrue)} : {self.visit(n.iffalse)}"

    def v_ExprList(self, n):
        return ", ".join(self.visit(e) for e in n.exprs)

    def v_Typename(self, n):
        return _render_type(n.type)

    def v_Decl(self, n):
        return n.name or ""


# A CFG fragment: nodes control enters through, nodes control falls out of.
Frag = tuple[list[int], list[int]]
EMPTY: Frag = ([], [])


class _Builder:
    """Walk one FunctionDef, emit nodes/edges, build the call-level CFG."""

    def __init__(self, line_offset: int = 0, next_id: int = 1000100):
        self.nodes: list[Node] = []
        self.edges: list[tuple[int, int, str]] = []
        self._next = next_id
        self.scope: list[dict[str, str]] = [{}]
        self.line_offset = line_offset
        self.method_return: int | None = None
        self._breaks: list[list[int]] = []
        self._continues: list[list[int]] = []
        self._labels: dict[str, int] = {}
        self._gotos: list[tuple[int, str]] = []

    # -- infra -----------------------------------------------------------
    def nid(self) -> int:
        self._next += 1
        return self._next

    def add_node(self, label, name="", code="", line=None, order=0, type_full_name="") -> int:
        i = self.nid()
        if line is not None:
            line = line - self.line_offset
        self.nodes.append(
            Node(i, label, name=name, code=code, line=line, order=order,
                 type_full_name=type_full_name)
        )
        return i

    def ast_edge(self, parent: int, child: int):
        self.edges.append((parent, child, "AST"))

    def arg_edge(self, call: int, arg: int):
        self.edges.append((call, arg, "ARGUMENT"))

    def cfg_edge(self, a: int, b: int):
        self.edges.append((a, b, "CFG"))

    def wire(self, frm: list[int], to: list[int]) -> None:
        for a in frm:
            for b in to:
                self.cfg_edge(a, b)

    def seq(self, *frags: Frag) -> Frag:
        """Sequence fragments, skipping transparent ones."""
        entries: list[int] = []
        exits: list[int] = []
        for e, x in frags:
            if not e and not x:
                continue
            if not entries:
                entries = e
            else:
                self.wire(exits, e)
            exits = x
        return entries, exits

    def lookup(self, name: str) -> str:
        for frame in reversed(self.scope):
            if name in frame:
                return frame[name]
        return "ANY"

    def line(self, n) -> int | None:
        try:
            return n.coord.line if n.coord else None
        except AttributeError:
            return None

    # -- expressions -----------------------------------------------------
    def expr(self, n, order: int = 1) -> tuple[int, Frag]:
        """Lower an expression; returns (root AST node id, CFG fragment)."""
        line = self.line(n)
        if isinstance(n, c_ast.Constant):
            tfn = {"int": "int", "float": "double", "double": "double",
                   "char": "char", "string": "char *"}.get(n.type, n.type)
            i = self.add_node("LITERAL", code=n.value, line=line, order=order,
                              type_full_name=tfn)
            return i, EMPTY
        if isinstance(n, c_ast.ID):
            i = self.add_node("IDENTIFIER", name=n.name, code=n.name, line=line,
                              order=order, type_full_name=self.lookup(n.name))
            return i, EMPTY
        if isinstance(n, c_ast.Assignment):
            op = ASSIGN_OPS[n.op]
            return self.call_node(f"<operator>.{op}", [n.lvalue, n.rvalue], n, order)
        if isinstance(n, c_ast.BinaryOp):
            if n.op in ("&&", "||"):
                return self.shortcircuit_node(n, order)
            op = BINARY_OPS.get(n.op, n.op)
            return self.call_node(f"<operator>.{op}", [n.left, n.right], n, order)
        if isinstance(n, c_ast.UnaryOp):
            op = UNARY_OPS.get(n.op, n.op)
            return self.call_node(f"<operator>.{op}", [n.expr], n, order)
        if isinstance(n, c_ast.ArrayRef):
            return self.call_node("<operator>.indexAccess", [n.name, n.subscript], n, order)
        if isinstance(n, c_ast.StructRef):
            op = "fieldAccess" if n.type == "." else "indirectFieldAccess"
            return self.call_node(f"<operator>.{op}", [n.name, n.field], n, order)
        if isinstance(n, c_ast.FuncCall):
            name = _code_of(n.name)
            args = list(n.args.exprs) if n.args else []
            return self.call_node(name, args, n, order)
        if isinstance(n, c_ast.Cast):
            # Joern: order 1 = type ref, order 2 = expression.
            call = self.add_node("CALL", name="<operator>.cast", code=_code_of(n),
                                 line=line, order=order)
            tref = self.add_node("TYPE_REF", code=_render_type(n.to_type.type),
                                 line=line, order=1,
                                 type_full_name=_render_type(n.to_type.type))
            self.ast_edge(call, tref)
            self.arg_edge(call, tref)
            sub, frag = self.expr(n.expr, order=2)
            self.ast_edge(call, sub)
            self.arg_edge(call, sub)
            frag = self.seq(frag, ([call], [call]))
            return call, frag
        if isinstance(n, c_ast.TernaryOp):
            return self.ternary_node(n, order)
        if isinstance(n, c_ast.ExprList):
            root = self.add_node("BLOCK", code=_code_of(n), line=line, order=order)
            frags = []
            for k, e in enumerate(n.exprs, 1):
                sub, fr = self.expr(e, order=k)
                self.ast_edge(root, sub)
                frags.append(fr)
            return root, self.seq(*frags)
        if isinstance(n, c_ast.Typename):
            t = _render_type(n.type)
            i = self.add_node("TYPE_REF", code=t, line=line, order=order, type_full_name=t)
            return i, EMPTY
        # fallback: opaque node, keeps graph well-formed
        i = self.add_node("UNKNOWN", code=_code_of(n), line=line, order=order)
        return i, EMPTY

    def call_node(self, name: str, operands: list, src, order: int) -> tuple[int, Frag]:
        """Strict-evaluation call: operand fragments in order, then the call."""
        line = self.line(src)
        call = self.add_node("CALL", name=name, code=_code_of(src), line=line, order=order)
        frags: list[Frag] = []
        for k, opnd in enumerate(operands, 1):
            sub, fr = self.expr(opnd, order=k)
            self.ast_edge(call, sub)
            self.arg_edge(call, sub)
            frags.append(fr)
        return call, self.seq(*frags, ([call], [call]))

    def shortcircuit_node(self, n: c_ast.BinaryOp, order: int) -> tuple[int, Frag]:
        """``a && b`` / ``a || b``: the right operand may be skipped, so the
        CFG forks after the left operand — both the right-operand path and the
        skip path reach the operator node."""
        line = self.line(n)
        op = BINARY_OPS[n.op]
        call = self.add_node("CALL", name=f"<operator>.{op}", code=_code_of(n),
                             line=line, order=order)
        lroot, lfrag = self.expr(n.left, order=1)
        self.ast_edge(call, lroot)
        self.arg_edge(call, lroot)
        rroot, rfrag = self.expr(n.right, order=2)
        self.ast_edge(call, rroot)
        self.arg_edge(call, rroot)
        if not rfrag[0]:
            # right side has no CFG nodes: degenerates to a plain chain
            return call, self.seq(lfrag, ([call], [call]))
        if lfrag[0]:
            self.wire(lfrag[1], rfrag[0])  # evaluate right
            self.wire(lfrag[1], [call])    # short-circuit skip
            self.wire(rfrag[1], [call])
            return call, (lfrag[0], [call])
        # left transparent: entry is both the right path and the call
        self.wire(rfrag[1], [call])
        return call, (rfrag[0] + [call], [call])

    def ternary_node(self, n: c_ast.TernaryOp, order: int) -> tuple[int, Frag]:
        """``c ? a : b`` forks like an if/else; both arms reach the operator."""
        line = self.line(n)
        call = self.add_node("CALL", name="<operator>.conditional", code=_code_of(n),
                             line=line, order=order)
        croot, cfrag = self.expr(n.cond, order=1)
        self.ast_edge(call, croot)
        self.arg_edge(call, croot)
        troot, tfrag = self.expr(n.iftrue, order=2)
        self.ast_edge(call, troot)
        self.arg_edge(call, troot)
        froot, ffrag = self.expr(n.iffalse, order=3)
        self.ast_edge(call, froot)
        self.arg_edge(call, froot)

        arm_entries: list[int] = []
        for e, x in (tfrag, ffrag):
            if e:
                arm_entries.extend(e)
                self.wire(x, [call])
            else:
                arm_entries.append(call)  # transparent arm falls straight through
        arm_entries = list(dict.fromkeys(arm_entries))
        if cfrag[0]:
            self.wire(cfrag[1], arm_entries)
            return call, (cfrag[0], [call])
        return call, (arm_entries, [call])

    def cond_frag(self, croot: int, cfrag: Frag) -> Frag:
        """Branch conditions are ALWAYS CFG-evaluated. A bare identifier /
        literal / member condition (``if (ptr)``, ``while (n)``,
        ``switch (op)``) lowers to an expression with no CALL inside, so its
        fragment is empty — without this, the construct would have no branch
        node: no path-sensitivity for reaching defs, no control dependence,
        and a ``switch`` would disconnect the CFG entirely. Joern gives every
        condition expression a CFG node; we promote the expression root."""
        if cfrag[0]:
            return cfrag
        return [croot], [croot]

    # -- statements ------------------------------------------------------
    def stmt(self, n, parent: int, order: int) -> Frag:
        """Lower a statement; returns its CFG fragment."""
        if n is None:
            return EMPTY
        line = self.line(n)

        if isinstance(n, c_ast.Compound):
            block = self.add_node("BLOCK", code="", line=line, order=order)
            self.ast_edge(parent, block)
            self.scope.append({})
            frag = self.seq(*[
                self.stmt(item, block, k)
                for k, item in enumerate(n.block_items or [], 1)
            ])
            self.scope.pop()
            return frag

        if isinstance(n, c_ast.DeclList):
            # for-init declarations: `for (int i = 0, j = n; ...)`
            return self.seq(*[self.stmt(d, parent, k) for k, d in enumerate(n.decls, 1)])

        if isinstance(n, c_ast.Decl):
            t = _render_type(n.type) if n.type is not None else "ANY"
            self.scope[-1][n.name] = t
            local = self.add_node("LOCAL", name=n.name or "", code=f"{t} {n.name}",
                                  line=line, order=order, type_full_name=t)
            self.ast_edge(parent, local)
            if n.init is not None:
                # int x = e  ≡  LOCAL + `x = e` assignment call (Joern shape)
                call = self.add_node("CALL", name="<operator>.assignment",
                                     code=f"{n.name} = {_code_of(n.init)}",
                                     line=line, order=order)
                self.ast_edge(parent, call)
                lhs = self.add_node("IDENTIFIER", name=n.name, code=n.name,
                                    line=line, order=1, type_full_name=t)
                self.ast_edge(call, lhs)
                self.arg_edge(call, lhs)
                rhs, frag = self.expr(n.init, order=2)
                self.ast_edge(call, rhs)
                self.arg_edge(call, rhs)
                return self.seq(frag, ([call], [call]))
            return EMPTY

        if isinstance(n, (c_ast.Assignment, c_ast.UnaryOp, c_ast.FuncCall,
                          c_ast.BinaryOp, c_ast.Cast, c_ast.TernaryOp,
                          c_ast.ExprList, c_ast.ID, c_ast.Constant,
                          c_ast.StructRef, c_ast.ArrayRef)):
            root, frag = self.expr(n, order=order)
            self.ast_edge(parent, root)
            return frag

        if isinstance(n, c_ast.If):
            cs = self.add_node("CONTROL_STRUCTURE", name="IF",
                               code=f"if ({_code_of(n.cond)})", line=line, order=order)
            self.ast_edge(parent, cs)
            croot, cfrag = self.expr(n.cond, order=1)
            self.ast_edge(cs, croot)
            self.edges.append((cs, croot, "CONDITION"))
            cfrag = self.cond_frag(croot, cfrag)
            tfrag = self.stmt(n.iftrue, cs, 2)
            ffrag = self.stmt(n.iffalse, cs, 3) if n.iffalse else EMPTY
            exits: list[int] = []
            for e, x in (tfrag, ffrag):
                if e:
                    self.wire(cfrag[1], e)
                    exits += x
                else:
                    exits += cfrag[1]  # fallthrough arm
            return cfrag[0], list(dict.fromkeys(exits))

        if isinstance(n, c_ast.While):
            cs = self.add_node("CONTROL_STRUCTURE", name="WHILE",
                               code=f"while ({_code_of(n.cond)})", line=line, order=order)
            self.ast_edge(parent, cs)
            croot, cfrag = self.expr(n.cond, order=1)
            self.ast_edge(cs, croot)
            self.edges.append((cs, croot, "CONDITION"))
            cfrag = self.cond_frag(croot, cfrag)
            self._breaks.append([])
            self._continues.append([])
            bfrag = self.stmt(n.stmt, cs, 2)
            brk, cont = self._breaks.pop(), self._continues.pop()
            self.wire(cfrag[1], bfrag[0] or cfrag[0])
            self.wire(bfrag[1] + cont, cfrag[0])
            return cfrag[0], cfrag[1] + brk

        if isinstance(n, c_ast.DoWhile):
            cs = self.add_node("CONTROL_STRUCTURE", name="DO",
                               code=f"do ... while ({_code_of(n.cond)})", line=line, order=order)
            self.ast_edge(parent, cs)
            self._breaks.append([])
            self._continues.append([])
            bfrag = self.stmt(n.stmt, cs, 1)
            brk, cont = self._breaks.pop(), self._continues.pop()
            croot, cfrag = self.expr(n.cond, order=2)
            self.ast_edge(cs, croot)
            self.edges.append((cs, croot, "CONDITION"))
            cfrag = self.cond_frag(croot, cfrag)
            self.wire(bfrag[1] + cont, cfrag[0])
            self.wire(cfrag[1], bfrag[0] or cfrag[0])
            entries = bfrag[0] or cfrag[0]
            return entries, cfrag[1] + brk

        if isinstance(n, c_ast.For):
            cs = self.add_node("CONTROL_STRUCTURE", name="FOR", code="for (...)",
                               line=line, order=order)
            self.ast_edge(parent, cs)
            self.scope.append({})
            ifrag = self.stmt(n.init, cs, 1) if n.init is not None else EMPTY
            if n.cond is not None:
                croot, cfrag = self.expr(n.cond, order=2)
                self.ast_edge(cs, croot)
                self.edges.append((cs, croot, "CONDITION"))
                cfrag = self.cond_frag(croot, cfrag)
            else:
                cfrag = EMPTY
            self._breaks.append([])
            self._continues.append([])
            bfrag = self.stmt(n.stmt, cs, 4)
            brk, cont = self._breaks.pop(), self._continues.pop()
            if n.next is not None:
                nroot, nfrag = self.expr(n.next, order=3)
                self.ast_edge(cs, nroot)
            else:
                nfrag = EMPTY
            self.scope.pop()

            # init -> cond -> body -> next -> cond ; cond -> after ; break -> after
            head = cfrag[0] or bfrag[0] or nfrag[0]
            self.wire(ifrag[1], head)
            if cfrag[0]:
                self.wire(cfrag[1], bfrag[0] or nfrag[0] or cfrag[0])
            self.wire(bfrag[1] + cont, nfrag[0] or head)
            if nfrag[0]:
                self.wire(nfrag[1], head)
            entries = ifrag[0] or head
            return entries, cfrag[1] + brk

        if isinstance(n, c_ast.Return):
            ret = self.add_node("RETURN", code=f"return {_code_of(n.expr)};".replace(" ;", ";"),
                                line=line, order=order)
            self.ast_edge(parent, ret)
            frag = EMPTY
            if n.expr is not None:
                eroot, frag = self.expr(n.expr, order=1)
                self.ast_edge(ret, eroot)
                self.arg_edge(ret, eroot)
            entries, _ = self.seq(frag, ([ret], [ret]))
            assert self.method_return is not None
            self.cfg_edge(ret, self.method_return)
            return entries, []  # no fallthrough

        if isinstance(n, c_ast.Break):
            node = self.add_node("CONTROL_STRUCTURE", name="BREAK", code="break;",
                                 line=line, order=order)
            self.ast_edge(parent, node)
            if self._breaks:
                self._breaks[-1].append(node)
            return [node], []

        if isinstance(n, c_ast.Continue):
            node = self.add_node("CONTROL_STRUCTURE", name="CONTINUE", code="continue;",
                                 line=line, order=order)
            self.ast_edge(parent, node)
            if self._continues:
                self._continues[-1].append(node)
            return [node], []

        if isinstance(n, c_ast.Switch):
            cs = self.add_node("CONTROL_STRUCTURE", name="SWITCH",
                               code=f"switch ({_code_of(n.cond)})", line=line, order=order)
            self.ast_edge(parent, cs)
            croot, cfrag = self.expr(n.cond, order=1)
            self.ast_edge(cs, croot)
            self.edges.append((cs, croot, "CONDITION"))
            cfrag = self.cond_frag(croot, cfrag)
            self._breaks.append([])
            prev_out: list[int] = []
            has_default = False
            items = n.stmt.block_items if isinstance(n.stmt, c_ast.Compound) else [n.stmt]
            for k, item in enumerate(items or [], 1):
                body = item.stmts if isinstance(item, (c_ast.Case, c_ast.Default)) else [item]
                if isinstance(item, c_ast.Default):
                    has_default = True
                case_frag = self.seq(*[
                    self.stmt(s, cs, k * 100 + j) for j, s in enumerate(body or [], 1)
                ])
                if case_frag[0]:
                    self.wire(prev_out, case_frag[0])  # fallthrough
                    if cfrag[1]:
                        self.wire(cfrag[1], case_frag[0])  # dispatch
                    prev_out = case_frag[1]
                # transparent case: fallthrough continues with prev_out
            brk = self._breaks.pop()
            exits = brk + prev_out
            if cfrag[1] and not has_default:
                exits = exits + cfrag[1]
            return cfrag[0], list(dict.fromkeys(exits))

        if isinstance(n, c_ast.Label):
            frag = self.stmt(n.stmt, parent, order)
            if not frag[0]:
                # label on a transparent statement (`done: ;`): materialise a
                # jump target so gotos have somewhere to land
                node = self.add_node("JUMP_TARGET", name=n.name, code=f"{n.name}:",
                                     line=line, order=order)
                self.ast_edge(parent, node)
                frag = ([node], [node])
            self._labels[n.name] = frag[0][0]
            return frag

        if isinstance(n, c_ast.Goto):
            node = self.add_node("CONTROL_STRUCTURE", name="GOTO", code=f"goto {n.name};",
                                 line=line, order=order)
            self.ast_edge(parent, node)
            self._gotos.append((node, n.name))
            return [node], []

        if isinstance(n, c_ast.EmptyStatement):
            return EMPTY

        # unhandled statement kind: opaque node, keep the chain connected
        node = self.add_node("UNKNOWN", code=type(n).__name__, line=line, order=order)
        self.ast_edge(parent, node)
        return [node], [node]

    # -- function --------------------------------------------------------
    def build(self, fdef: c_ast.FuncDef) -> None:
        decl = fdef.decl
        ftype = decl.type  # FuncDecl
        fname = decl.name
        line = self.line(fdef)
        ret_t = _render_type(ftype.type)
        method = self.add_node("METHOD", name=fname, code=_code_of(decl) or fname,
                               line=line, type_full_name=ret_t)
        self.method_return = self.add_node("METHOD_RETURN", code="RET", line=line,
                                           type_full_name=ret_t)
        self.ast_edge(method, self.method_return)

        params = ftype.args.params if ftype.args else []
        self.scope.append({})
        for k, p in enumerate(params, 1):
            if isinstance(p, c_ast.Decl):
                t = _render_type(p.type)
                self.scope[-1][p.name] = t
                pn = self.add_node("METHOD_PARAMETER_IN", name=p.name or "",
                                   code=f"{t} {p.name}", line=self.line(p), order=k,
                                   type_full_name=t)
                self.ast_edge(method, pn)

        entries, exits = self.stmt(fdef.body, method, 1)
        self.scope.pop()
        self.wire([method], entries or [self.method_return])
        self.wire(exits, [self.method_return])
        for node, label in self._gotos:
            if label in self._labels:
                self.cfg_edge(node, self._labels[label])
        self._gotos.clear()
        self._labels.clear()


def parse_functions(code: str) -> list[tuple[str, CPG]]:
    """Parse C source into one ``(function name, CPG)`` pair PER function —
    the `predict` scan surface scores and reports each function separately
    (the reference corpus is one function per row, ``datasets.py:159-198``;
    a raw file is not). Each function gets a fresh ``_Builder`` (own
    scopes/labels); node ids are disjoint across functions."""
    ast, n_typedefs = _parse_with_recovery(_preprocess(code))
    out: list[tuple[str, CPG]] = []
    next_id = 1000100
    for ext in ast.ext:
        if isinstance(ext, c_ast.FuncDef):
            builder = _Builder(line_offset=n_typedefs, next_id=next_id)
            builder.build(ext)
            name = getattr(ext.decl, "name", None) or f"func_{len(out)}"
            out.append((name, CPG(builder.nodes, builder.edges)))
            next_id = builder._next + 100
    if not out:
        raise FrontendError("no function definition found")
    return out


def parse_source(code: str) -> CPG:
    """Parse C source (possibly several functions) into one CPG — the merge
    of :func:`parse_functions` (ONE parsing loop; file-mode and
    per-function-mode must never diverge)."""
    all_nodes: list[Node] = []
    all_edges: list[tuple[int, int, str]] = []
    for _name, cpg in parse_functions(code):
        all_nodes.extend(cpg.nodes.values())
        all_edges.extend(cpg.edges)
    return CPG(all_nodes, all_edges)


def parse_function(code: str) -> CPG:
    """Parse a single C function (the per-function extraction contract the
    reference used with Joern: one ``{id}.c`` file per Big-Vul function)."""
    return parse_source(code)
