"""``pw.sql`` — a SQL → Table-operations compiler.

Parity target: ``python/pathway/internals/sql.py`` (726 LoC,
sqlglot-based).  sqlglot is not available in this environment, so this is a
self-contained tokenizer + recursive-descent parser covering the subset the
reference documents:

* SELECT projections (``*``, ``tbl.*``, expressions, aliases), DISTINCT
* FROM with multiple tables / aliases, comma cross-joins, and
  INNER/LEFT/RIGHT/FULL OUTER JOIN ... ON with equality conditions
  (extra non-equi ON terms become post-filters on inner joins)
* WHERE with AND/OR/NOT, comparisons, BETWEEN, IN (literal list),
  IS [NOT] NULL
* GROUP BY (columns or expressions) with aggregates COUNT(*)/COUNT(x)/
  SUM/AVG/MIN/MAX, and HAVING (aggregates allowed)
* subqueries in FROM: ``SELECT ... FROM (SELECT ...) alias``
* UNION ALL (concatenation) and UNION (deduplicating), INTERSECT and
  EXCEPT (distinct set semantics, value-based, INTERSECT binding tighter
  as in standard SQL)
* WITH (non-recursive CTEs, referencable by later CTEs and the body)
* uncorrelated scalar subqueries in WHERE/HAVING
  (``WHERE v > (SELECT AVG(v) FROM t)`` — must be a single-row aggregate)
* projection-alias reuse in HAVING (``SELECT SUM(v) AS s ... HAVING s > 3``)
* CASE (searched and simple forms, aggregates allowed in branches under
  GROUP BY), IF(cond, a, b), NULLIF(a, b), COALESCE

Not covered (as in the reference's documented limitations): correlated
subqueries, window functions, ORDER BY/LIMIT (meaningless on streams).
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import reducers
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference, coalesce
from pathway_tpu_torch.internals.table import JoinMode, JoinResult, Table
from pathway_tpu_torch.internals.thisclass import left as left_ph, right as right_ph, this

_AGG_NAMES = {"count", "sum", "avg", "min", "max"}
_AGGS = {
    "count": reducers.count,
    "sum": reducers.sum,
    "avg": reducers.avg,
    "min": reducers.min,
    "max": reducers.max,
}

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "union",
    "all", "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "as", "and", "or", "not", "is", "null", "between", "in", "true", "false",
    "with", "recursive", "intersect", "except", "case", "when", "then",
    "else", "end",
}


class SqlError(ValueError):
    pass


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)
    """,
    re.VERBOSE,
)


def _tokenize(q: str) -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    pos = 0
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if not m:
            raise SqlError(f"cannot tokenize SQL near {q[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "num":
            out.append(("num", float(text) if "." in text else int(text)))
        elif m.lastgroup == "str":
            out.append(("str", text[1:-1].replace("''", "'")))
        elif m.lastgroup == "name":
            low = text.lower()
            if low in _KEYWORDS:
                out.append(("kw", low))
            else:
                out.append(("name", text))
        else:
            out.append(("op", text))
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, Any]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> tuple[str, Any]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> tuple[str, Any]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> str | None:
        t, v = self.peek()
        if t == "kw" and v in kws:
            self.next()
            return v
        return None

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SqlError(f"expected {kw.upper()!r}, got {self.peek()!r}")

    def accept_op(self, *ops: str) -> str | None:
        t, v = self.peek()
        if t == "op" and v in ops:
            self.next()
            return v
        return None

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r}, got {self.peek()!r}")

    def expect_name(self) -> str:
        t, v = self.next()
        if t != "name":
            raise SqlError(f"expected identifier, got {(t, v)!r}")
        return v


# ---------------------------------------------------------------------------
# AST (plain tuples keep the parser small)
#   ("col", qualifier|None, name) ("const", v) ("bin", op, l, r)
#   ("and", l, r) ("or", l, r) ("not", e) ("isnull", e, negate)
#   ("agg", fname, arg|None) ("func", fname, args) ("star", qualifier|None)
# ---------------------------------------------------------------------------


def _parse_expr(p: _Parser):
    return _parse_or(p)


def _parse_or(p: _Parser):
    e = _parse_and(p)
    while p.accept_kw("or"):
        e = ("or", e, _parse_and(p))
    return e


def _parse_and(p: _Parser):
    e = _parse_not(p)
    while p.accept_kw("and"):
        e = ("and", e, _parse_not(p))
    return e


def _parse_not(p: _Parser):
    if p.accept_kw("not"):
        return ("not", _parse_not(p))
    return _parse_cmp(p)


def _parse_cmp(p: _Parser):
    e = _parse_add(p)
    op = p.accept_op("=", "!=", "<>", "<", "<=", ">", ">=")
    if op:
        r = _parse_add(p)
        return ("bin", {"<>": "!=", "=": "=="}.get(op, op), e, r)
    if p.accept_kw("is"):
        negate = bool(p.accept_kw("not"))
        p.expect_kw("null")
        return ("isnull", e, negate)
    if p.accept_kw("between"):
        lo = _parse_add(p)
        p.expect_kw("and")
        hi = _parse_add(p)
        return ("and", ("bin", ">=", e, lo), ("bin", "<=", e, hi))
    if p.accept_kw("not"):
        p.expect_kw("in")
        return ("not", _parse_in_tail(p, e))
    if p.accept_kw("in"):
        return _parse_in_tail(p, e)
    return e


def _parse_in_tail(p: _Parser, e):
    p.expect_op("(")
    if p.peek() in (("kw", "select"), ("kw", "with")):
        raise SqlError(
            "IN (SELECT ...) subqueries are not supported; rewrite as a JOIN"
        )
    items = [_parse_add(p)]
    while p.accept_op(","):
        items.append(_parse_add(p))
    p.expect_op(")")
    out = ("bin", "==", e, items[0])
    for it in items[1:]:
        out = ("or", out, ("bin", "==", e, it))
    return out


def _parse_add(p: _Parser):
    e = _parse_mul(p)
    while True:
        op = p.accept_op("+", "-")
        if not op:
            return e
        e = ("bin", op, e, _parse_mul(p))


def _parse_mul(p: _Parser):
    e = _parse_unary(p)
    while True:
        op = p.accept_op("*", "/", "%")
        if not op:
            return e
        e = ("bin", op, e, _parse_unary(p))


def _parse_unary(p: _Parser):
    if p.accept_op("-"):
        return ("bin", "-", ("const", 0), _parse_unary(p))
    return _parse_primary(p)


def _parse_primary(p: _Parser):
    t, v = p.peek()
    if t == "num" or t == "str":
        p.next()
        return ("const", v)
    if t == "kw" and v in ("true", "false"):
        p.next()
        return ("const", v == "true")
    if t == "kw" and v == "null":
        p.next()
        return ("const", None)
    if t == "kw" and v == "case":
        # CASE [operand] WHEN x THEN y [WHEN ...] [ELSE z] END
        # (searched and simple forms — sqlglot's Case node in the
        # reference maps to the same if_else chain, sql.py:69)
        p.next()
        operand = None
        if p.peek() != ("kw", "when"):
            operand = _parse_expr(p)
        whens = []
        while p.accept_kw("when"):
            cond = _parse_expr(p)
            p.expect_kw("then")
            whens.append((cond, _parse_expr(p)))
        default = ("const", None)
        if p.accept_kw("else"):
            default = _parse_expr(p)
        p.expect_kw("end")
        if not whens:
            raise SqlError("CASE requires at least one WHEN clause")
        # operand stays a single AST node: the simple form compiles it ONCE
        # and shares the compiled expression across every WHEN comparison
        return ("case", operand, whens, default)
    if t == "op" and v == "(":
        p.next()
        if p.peek() in (("kw", "select"), ("kw", "with")):
            sub = _parse_query(p)
            p.expect_op(")")
            return ("scalar_subquery", sub)
        e = _parse_expr(p)
        p.expect_op(")")
        return e
    if t == "op" and v == "*":
        p.next()
        return ("star", None)
    if t == "name":
        name = p.expect_name()
        if p.peek() == ("op", "("):
            p.next()
            fname = name.lower()
            if p.accept_op(")"):
                args = []
            else:
                if fname == "count" and p.peek() == ("op", "*"):
                    p.next()
                    p.expect_op(")")
                    return ("agg", "count", None)
                args = [_parse_expr(p)]
                while p.accept_op(","):
                    args.append(_parse_expr(p))
                p.expect_op(")")
            if fname in _AGG_NAMES:
                return ("agg", fname, args[0] if args else None)
            return ("func", fname, args)
        if p.peek() == ("op", "."):
            p.next()
            if p.peek() == ("op", "*"):
                p.next()
                return ("star", name)
            col = p.expect_name()
            return ("col", name, col)
        return ("col", None, name)
    raise SqlError(f"unexpected token {(t, v)!r}")


# ---------------------------------------------------------------------------
# SELECT statement structure
# ---------------------------------------------------------------------------


def _parse_select(p: _Parser) -> dict:
    p.expect_kw("select")
    distinct = bool(p.accept_kw("distinct"))
    projections = []  # (ast | ("star", qual), alias | None)
    while True:
        e = _parse_expr(p)
        alias = None
        if p.accept_kw("as"):
            alias = p.expect_name()
        elif p.peek()[0] == "name":
            alias = p.expect_name()
        projections.append((e, alias))
        if not p.accept_op(","):
            break
    p.expect_kw("from")
    from_items = [_parse_from_item(p)]
    joins = []  # (mode, item, on_ast | None)
    while True:
        if p.accept_op(","):
            joins.append(("cross", _parse_from_item(p), None))
            continue
        mode = None
        if p.accept_kw("cross"):
            p.expect_kw("join")
            joins.append(("cross", _parse_from_item(p), None))
            continue
        if p.accept_kw("inner"):
            mode = "inner"
        elif p.accept_kw("left"):
            p.accept_kw("outer")
            mode = "left"
        elif p.accept_kw("right"):
            p.accept_kw("outer")
            mode = "right"
        elif p.accept_kw("full"):
            p.accept_kw("outer")
            mode = "outer"
        if mode is None and not (p.peek() == ("kw", "join")):
            break
        p.expect_kw("join")
        item = _parse_from_item(p)
        p.expect_kw("on")
        on = _parse_expr(p)
        joins.append((mode or "inner", item, on))
    where = group = having = None
    if p.accept_kw("where"):
        where = _parse_expr(p)
    if p.accept_kw("group"):
        p.expect_kw("by")
        group = [_parse_expr(p)]
        while p.accept_op(","):
            group.append(_parse_expr(p))
    if p.accept_kw("having"):
        having = _parse_expr(p)
    return dict(
        distinct=distinct,
        projections=projections,
        from_items=from_items,
        joins=joins,
        where=where,
        group=group,
        having=having,
    )


def _parse_from_item(p: _Parser):
    if p.peek() == ("op", "("):
        p.next()
        sub = _parse_query(p)
        p.expect_op(")")
        p.accept_kw("as")
        alias = p.expect_name()
        return ("subquery", sub, alias)
    name = p.expect_name()
    alias = None
    if p.accept_kw("as"):
        alias = p.expect_name()
    elif p.peek()[0] == "name":
        alias = p.expect_name()
    return ("table", name, alias or name)


def _parse_query(p: _Parser):
    ctes = []
    if p.accept_kw("with"):
        if p.accept_kw("recursive"):
            raise SqlError("WITH RECURSIVE is not supported; use pw.iterate")
        while True:
            name = p.expect_name()
            p.expect_kw("as")
            p.expect_op("(")
            sub = _parse_query(p)
            p.expect_op(")")
            ctes.append((name, sub))
            if not p.accept_op(","):
                break
    stmts = [_parse_select(p)]
    ops = []  # ("union"|"intersect"|"except", "all"|"distinct")
    while True:
        if p.accept_kw("union"):
            ops.append(("union", "all" if p.accept_kw("all") else "distinct"))
        elif p.accept_kw("intersect"):
            if p.accept_kw("all"):
                raise SqlError("INTERSECT ALL is not supported")
            ops.append(("intersect", "distinct"))
        elif p.accept_kw("except"):
            if p.accept_kw("all"):
                raise SqlError("EXCEPT ALL is not supported")
            ops.append(("except", "distinct"))
        else:
            break
        stmts.append(_parse_select(p))
    body = ("compound", stmts, ops) if ops else ("select", stmts[0])
    return ("with", ctes, body) if ctes else body


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


class _Env:
    """Name resolution over a working table with mangled column names."""

    def __init__(self, table: Table, qualified: dict[tuple[str, str], str]):
        # qualified: (alias, col) -> mangled column name in `table`
        self.table = table
        self.qualified = qualified

    def resolve(self, qualifier: str | None, name: str) -> ColumnExpression:
        if qualifier is not None:
            key = (qualifier, name)
            if key not in self.qualified:
                raise SqlError(f"unknown column {qualifier}.{name}")
            return ColumnReference(this, self.qualified[key])
        hits = [m for (al, col), m in self.qualified.items() if col == name]
        if not hits:
            raise SqlError(f"unknown column {name!r}")
        if len(set(hits)) > 1:
            raise SqlError(f"ambiguous column {name!r}; qualify it")
        return ColumnReference(this, hits[0])

    def all_columns(self, qualifier: str | None) -> list[tuple[str, str]]:
        """[(output name, mangled name)] for SELECT * / alias.*"""
        out = []
        seen = set()
        for (al, col), m in self.qualified.items():
            if al.startswith("#"):
                continue  # hidden scalar-subquery bindings
            if qualifier is not None and al != qualifier:
                continue
            if col in seen:
                raise SqlError(
                    f"SELECT {'*' if qualifier is None else qualifier + '.*'}: "
                    f"duplicate column name {col!r}; project explicitly"
                )
            seen.add(col)
            out.append((col, m))
        return out


def _compile_scalar(ast, env: _Env, agg_ok: bool = False) -> Any:
    kind = ast[0]
    if kind == "const":
        return expr_mod.ColumnConstExpression(ast[1])
    if kind == "col":
        return env.resolve(ast[1], ast[2])
    if kind == "bin":
        op, l_ast, r_ast = ast[1], ast[2], ast[3]
        le = _compile_scalar(l_ast, env, agg_ok)
        re_ = _compile_scalar(r_ast, env, agg_ok)
        return expr_mod.ColumnBinaryOpExpression(op, le, re_)
    if kind == "and":
        return expr_mod.ColumnBinaryOpExpression(
            "&", _compile_scalar(ast[1], env, agg_ok), _compile_scalar(ast[2], env, agg_ok)
        )
    if kind == "or":
        return expr_mod.ColumnBinaryOpExpression(
            "|", _compile_scalar(ast[1], env, agg_ok), _compile_scalar(ast[2], env, agg_ok)
        )
    if kind == "not":
        return ~_compile_scalar(ast[1], env, agg_ok)
    if kind == "isnull":
        e = _compile_scalar(ast[1], env, agg_ok)
        return e.is_not_none() if ast[2] else e.is_none()
    if kind == "agg":
        if not agg_ok:
            raise SqlError("aggregate outside GROUP BY context")
        fname, arg = ast[1], ast[2]
        if fname == "count" and arg is None:
            return reducers.count()
        return _AGGS[fname](_compile_scalar(arg, env, agg_ok))
    if kind == "case":
        operand, whens, default = ast[1], ast[2], ast[3]
        op_expr = (
            _compile_scalar(operand, env, agg_ok) if operand is not None else None
        )
        out = _compile_scalar(default, env, agg_ok)
        for cond_ast, then_ast in reversed(whens):
            cond = _compile_scalar(cond_ast, env, agg_ok)
            if op_expr is not None:
                cond = expr_mod.ColumnBinaryOpExpression("==", op_expr, cond)
            out = expr_mod.IfElseExpression(
                cond, _compile_scalar(then_ast, env, agg_ok), out
            )
        return out
    if kind == "func":
        fname, args = ast[1], ast[2]
        compiled = [_compile_scalar(a, env, agg_ok) for a in args]
        if fname == "coalesce":
            return coalesce(*compiled)
        if fname in ("if", "iff"):
            if len(compiled) != 3:
                raise SqlError(
                    f"IF takes 3 arguments (condition, then, else); got {len(compiled)}"
                )
            return expr_mod.IfElseExpression(*compiled)
        if fname == "nullif":
            if len(compiled) != 2:
                raise SqlError(f"NULLIF takes 2 arguments; got {len(compiled)}")
            return expr_mod.IfElseExpression(
                expr_mod.ColumnBinaryOpExpression("==", compiled[0], compiled[1]),
                expr_mod.ColumnConstExpression(None),
                compiled[0],
            )
        raise SqlError(f"unsupported SQL function {fname!r}")
    if kind == "anycol":
        # a scalar-subquery placeholder inside HAVING: constant per group,
        # so ANY over the group extracts it through the reduce
        return reducers.any(env.resolve(ast[1], ast[2]))
    if kind == "scalar_subquery":
        raise SqlError(
            "scalar subqueries are only supported in WHERE and HAVING"
        )
    if kind == "star":
        raise SqlError("* only allowed as a projection or inside COUNT(*)")
    raise SqlError(f"cannot compile {ast!r}")


def _ast_columns(ast) -> list[tuple[str | None, str]]:
    """All (qualifier, name) column refs in an expression ast."""
    kind = ast[0]
    if kind == "col":
        return [(ast[1], ast[2])]
    if kind in ("bin",):
        return _ast_columns(ast[2]) + _ast_columns(ast[3])
    if kind in ("and", "or"):
        return _ast_columns(ast[1]) + _ast_columns(ast[2])
    if kind == "not":
        return _ast_columns(ast[1])
    if kind == "isnull":
        return _ast_columns(ast[1])
    if kind == "agg":
        return _ast_columns(ast[2]) if ast[2] is not None else []
    if kind == "func":
        return [c for a in ast[2] for c in _ast_columns(a)]
    if kind == "case":
        operand, whens, default = ast[1], ast[2], ast[3]
        out = [] if operand is None else _ast_columns(operand)
        out += [c for (cond, then) in whens
                for c in _ast_columns(cond) + _ast_columns(then)]
        return out + _ast_columns(default)
    return []


def _split_equalities(on_ast, left_aliases: set[str], right_alias: str):
    """Split an ON expression into equi-join pairs + residual conditions.

    Returns (pairs, residual) with pairs = [(left_ast, right_ast)].
    """
    conjuncts = []

    def walk(a):
        if a[0] == "and":
            walk(a[1])
            walk(a[2])
        else:
            conjuncts.append(a)

    walk(on_ast)
    pairs, residual = [], []
    for c in conjuncts:
        if c[0] == "bin" and c[1] == "==":
            l_cols = {q for (q, _n) in _ast_columns(c[2])}
            r_cols = {q for (q, _n) in _ast_columns(c[3])}
            if l_cols <= left_aliases and r_cols == {right_alias}:
                pairs.append((c[2], c[3]))
                continue
            if r_cols <= left_aliases and l_cols == {right_alias}:
                pairs.append((c[3], c[2]))
                continue
        residual.append(c)
    return pairs, residual


def _mangle(alias: str, col: str) -> str:
    # length prefix keeps the split point unambiguous: aliases and columns
    # may themselves contain underscores
    return f"_pw{len(alias)}_{alias}_{col}"


def _table_env(table: Table, alias: str) -> _Env:
    """Working table for a single FROM item: columns mangled by alias."""
    mapping = {(alias, c): _mangle(alias, c) for c in table.column_names()}
    working = table.select(
        **{m: ColumnReference(this, c) for (al, c), m in mapping.items()}
    )
    return _Env(working, mapping)


def _compile_from(stmt: dict, tables: dict[str, Table]) -> _Env:
    def item_env(item) -> _Env:
        if item[0] == "subquery":
            sub = _compile_query(item[1], tables)
            return _table_env(sub, item[2])
        _, name, alias = item
        if name not in tables:
            raise SqlError(f"unknown table {name!r}")
        return _table_env(tables[name], alias)

    env = item_env(stmt["from_items"][0])
    for mode, item, on_ast in stmt["joins"]:
        renv = item_env(item)
        merged_qualified = dict(env.qualified)
        for k, v in renv.qualified.items():
            if k in merged_qualified:
                raise SqlError(f"duplicate table alias {k[0]!r}")
            merged_qualified[k] = v

        if mode == "cross":
            on_conds = [
                expr_mod.ColumnBinaryOpExpression(
                    "==",
                    expr_mod.ColumnConstExpression(0),
                    expr_mod.ColumnConstExpression(0),
                )
            ]
            jmode = JoinMode.INNER
            residual = []
        else:
            left_aliases = {al for (al, _c) in env.qualified}
            right_alias = next(iter({al for (al, _c) in renv.qualified}))
            pairs, residual = _split_equalities(on_ast, left_aliases, right_alias)
            if not pairs:
                raise SqlError("JOIN ... ON requires at least one equality")
            jmode = {
                "inner": JoinMode.INNER,
                "left": JoinMode.LEFT,
                "right": JoinMode.RIGHT,
                "outer": JoinMode.OUTER,
            }[mode]
            if residual and jmode is not JoinMode.INNER:
                raise SqlError(
                    "non-equality ON conditions are only supported for INNER JOIN"
                )
            on_conds = []
            for l_ast, r_ast in pairs:
                le = _rebind(_compile_scalar(l_ast, env), left_ph)
                re_ = _rebind(_compile_scalar(r_ast, renv), right_ph)
                on_conds.append(expr_mod.ColumnBinaryOpExpression("==", le, re_))

        jr = JoinResult(env.table, renv.table, on_conds, mode=jmode)
        sel = {}
        for (_al, _c), m in env.qualified.items():
            sel[m] = ColumnReference(left_ph, m)
        for (_al, _c), m in renv.qualified.items():
            sel[m] = ColumnReference(right_ph, m)
        working = jr.select(**sel)
        env = _Env(working, merged_qualified)
        for cond_ast in residual:
            env = _Env(
                env.table.filter(_compile_scalar(cond_ast, env)), env.qualified
            )
    return env


def _rebind(e: ColumnExpression, ph) -> ColumnExpression:
    """Rewrite `this`-references onto a join-side placeholder."""
    if isinstance(e, ColumnReference):
        return ColumnReference(ph, e.name)
    new = e._substitute({})
    for attr in getattr(new, "__slots__", ()):
        try:
            v = getattr(new, attr)
        except AttributeError:
            continue
        if isinstance(v, ColumnExpression):
            object.__setattr__(new, attr, _rebind(v, ph))
        elif isinstance(v, tuple) and any(isinstance(x, ColumnExpression) for x in v):
            object.__setattr__(
                new, attr, tuple(_rebind(x, ph) if isinstance(x, ColumnExpression) else x for x in v)
            )
    return new


def _has_agg(ast) -> bool:
    if ast[0] == "agg":
        return True
    if ast[0] in ("bin",):
        return _has_agg(ast[2]) or _has_agg(ast[3])
    if ast[0] in ("and", "or"):
        return _has_agg(ast[1]) or _has_agg(ast[2])
    if ast[0] in ("not", "isnull"):
        return _has_agg(ast[1])
    if ast[0] == "func":
        return any(_has_agg(a) for a in ast[2])
    if ast[0] == "case":
        operand, whens, default = ast[1], ast[2], ast[3]
        if operand is not None and _has_agg(operand):
            return True
        return any(
            _has_agg(c) or _has_agg(th) for (c, th) in whens
        ) or _has_agg(default)
    return False


# ---------------------------------------------------------------------------
# scalar subqueries (uncorrelated, WHERE/HAVING)
# ---------------------------------------------------------------------------


def _rewrite_subqueries(ast, found: list, col_kind: str):
    """Replace ``scalar_subquery`` nodes with placeholder column refs
    (qualifier ``#subqN``); collects the subquery asts in ``found``."""
    if isinstance(ast, list):
        return [_rewrite_subqueries(x, found, col_kind) for x in ast]
    if not isinstance(ast, tuple):
        return ast
    if ast[0] == "scalar_subquery":
        idx = len(found)
        found.append(ast[1])
        return (col_kind, f"#subq{idx}", "val")
    return tuple(_rewrite_subqueries(x, found, col_kind) for x in ast)


def _scalar_subquery_table(q_ast, tables: dict[str, Table]) -> Table:
    """Compile a scalar subquery; enforce single-row shape statically.

    Streams have no runtime "more than one row" error point, so the
    single-row guarantee must hold by construction: exactly one aggregate
    projection, no GROUP BY, no set operations.
    """
    scoped = dict(tables)
    body = q_ast
    while body[0] == "with":
        for name, sub in body[1]:
            scoped[name] = _compile_query(sub, scoped)
        body = body[2]
    if body[0] != "select":
        raise SqlError("scalar subquery cannot be a UNION/INTERSECT/EXCEPT")
    s = body[1]
    projs = s["projections"]
    if (
        s["group"] is not None
        or len(projs) != 1
        or projs[0][0][0] == "star"
        or not _has_agg(projs[0][0])
    ):
        raise SqlError(
            "scalar subquery must be a single aggregate projection without "
            "GROUP BY (uncorrelated)"
        )
    return _compile_select(s, scoped)


def _attach_scalar_subqueries(stmt: dict, env: _Env, tables: dict[str, Table]) -> _Env:
    """Cross-join each uncorrelated scalar subquery's single-row result
    onto the working table so WHERE/HAVING can reference it as a column."""
    found: list = []  # WHERE and HAVING placeholders share one numbering
    if stmt["where"] is not None:
        stmt["where"] = _rewrite_subqueries(stmt["where"], found, "col")
    if stmt["having"] is not None:
        stmt["having"] = _rewrite_subqueries(stmt["having"], found, "anycol")
    if not found:
        return env
    qualified = dict(env.qualified)
    working = env.table
    for i, sub_ast in enumerate(found):
        sub = _scalar_subquery_table(sub_ast, tables)
        mangled = f"_pw_subq_{i}"
        sub1 = sub.select(
            **{mangled: ColumnReference(this, sub.column_names()[0])}
        )
        always = expr_mod.ColumnBinaryOpExpression(
            "==",
            expr_mod.ColumnConstExpression(0),
            expr_mod.ColumnConstExpression(0),
        )
        jr = JoinResult(working, sub1, [always], mode=JoinMode.INNER)
        sel = {m: ColumnReference(left_ph, m) for m in working.column_names()}
        sel[mangled] = ColumnReference(right_ph, mangled)
        working = jr.select(**sel)
        qualified[(f"#subq{i}", "val")] = mangled
    return _Env(working, qualified)


def _projection_name(ast, alias: str | None, auto: list[int]) -> str:
    if alias:
        return alias
    if ast[0] == "col":
        return ast[2]
    if ast[0] == "agg":
        # COUNT(x) -> count, SUM(y) -> sum — matches common SQL defaults
        return ast[1]
    auto[0] += 1
    return f"col_{auto[0] - 1}"


def _rewrite_having_aliases(ast, alias_map: dict, env: _Env):
    """HAVING may reuse projection aliases (``SELECT SUM(v) AS s ...
    HAVING s > 3``).  A name that resolves as a source column wins (the
    standard rule); otherwise a matching projection's expression is
    substituted."""
    if isinstance(ast, list):
        return [_rewrite_having_aliases(x, alias_map, env) for x in ast]
    if not isinstance(ast, tuple):
        return ast
    if ast[0] == "col" and ast[1] is None:
        name = ast[2]
        try:
            env.resolve(None, name)
            return ast
        except SqlError:
            if name in alias_map:
                return alias_map[name]
            return ast
    return tuple(_rewrite_having_aliases(x, alias_map, env) for x in ast)


def _compile_select(stmt: dict, tables: dict[str, Table]) -> Table:
    env = _compile_from(stmt, tables)
    env = _attach_scalar_subqueries(stmt, env, tables)

    if stmt["where"] is not None:
        env = _Env(env.table.filter(_compile_scalar(stmt["where"], env)), env.qualified)

    auto = [0]
    agg_query = stmt["group"] is not None or any(
        _has_agg(e) for (e, _a) in stmt["projections"]
    )

    select_exprs: dict[str, Any] = {}

    def add_projection(name: str, expr) -> None:
        if name in select_exprs:
            raise SqlError(
                f"duplicate output column {name!r}; alias the projections"
            )
        select_exprs[name] = expr

    for e, alias in stmt["projections"]:
        if e[0] == "star":
            for out_name, mangled in env.all_columns(e[1]):
                add_projection(out_name, ColumnReference(this, mangled))
            continue
        add_projection(
            _projection_name(e, alias, auto), _compile_scalar(e, env, agg_ok=agg_query)
        )

    if not agg_query:
        result = env.table.select(**select_exprs)
        if stmt["having"] is not None:
            raise SqlError("HAVING requires GROUP BY or aggregates")
        if stmt["distinct"]:
            result = _distinct(result)
        return result

    # group keys: plain columns group directly; expressions materialize first
    work = env.table
    group_refs = []
    if stmt["group"]:
        extra = {}
        for i, g_ast in enumerate(stmt["group"]):
            if g_ast[0] == "col":
                group_refs.append(env.resolve(g_ast[1], g_ast[2]))
            else:
                gname = f"_pw_groupexpr_{i}"
                extra[gname] = _compile_scalar(g_ast, env)
                group_refs.append(ColumnReference(this, gname))
        if extra:
            work = work.with_columns(**extra)

    having_name = None
    if stmt["having"] is not None:
        alias_map = {
            (alias or (e[2] if e[0] == "col" else e[1] if e[0] == "agg" else None)): e
            for e, alias in stmt["projections"]
            if e[0] != "star"
        }
        alias_map.pop(None, None)
        having_ast = _rewrite_having_aliases(stmt["having"], alias_map, env)
        having_name = "_pw_having"
        select_exprs[having_name] = _compile_scalar(having_ast, env, agg_ok=True)

    if group_refs:
        result = work.groupby(*group_refs).reduce(**select_exprs)
    else:
        result = work.reduce(**select_exprs)
    if having_name:
        result = result.filter(ColumnReference(this, having_name)).without(having_name)
    if stmt["distinct"]:
        result = _distinct(result)
    return result


def _distinct(table: Table) -> Table:
    refs = [ColumnReference(this, n) for n in table.column_names()]
    return table.groupby(*refs).reduce(
        **{n: ColumnReference(this, n) for n in table.column_names()}
    )


def _align_columns(a: Table, b: Table) -> Table:
    """Rename ``b``'s columns positionally to ``a``'s (set-op convention:
    the first query names the output)."""
    a_names, b_names = a.column_names(), b.column_names()
    if len(a_names) != len(b_names):
        raise SqlError(
            f"set operation arity mismatch: {len(a_names)} vs {len(b_names)} columns"
        )
    if a_names == b_names:
        return b
    return b.select(
        **{an: ColumnReference(this, bn) for an, bn in zip(a_names, b_names)}
    )


def _set_op(a: Table, b: Table, keep: str) -> Table:
    """Value-based INTERSECT / EXCEPT with distinct set semantics.

    Tag rows by side, concat, group by every value column, keep groups by
    side-presence.  Grouping (not joining) makes NULLs compare equal, the
    SQL set-operation rule that a join-based plan would violate.
    """
    b = _align_columns(a, b)
    names = a.column_names()
    ta = a.with_columns(_pw_setl=1, _pw_setr=0)
    tb = b.with_columns(_pw_setl=0, _pw_setr=1)
    both = ta.concat_reindex(tb)
    refs = [ColumnReference(this, n) for n in names]
    grouped = both.groupby(*refs).reduce(
        **{n: ColumnReference(this, n) for n in names},
        _pw_setl=reducers.sum(ColumnReference(this, "_pw_setl")),
        _pw_setr=reducers.sum(ColumnReference(this, "_pw_setr")),
    )
    l_ref = ColumnReference(this, "_pw_setl")
    r_ref = ColumnReference(this, "_pw_setr")
    if keep == "intersect":
        cond = (l_ref > 0) & (r_ref > 0)
    else:  # except
        cond = (l_ref > 0) & (r_ref == 0)
    return grouped.filter(cond).without("_pw_setl", "_pw_setr")


def _compile_query(ast, tables: dict[str, Table]) -> Table:
    if ast[0] == "with":
        # CTEs: each is visible to later CTEs and the body; user tables of
        # the same name are shadowed for this query only
        scoped = dict(tables)
        for name, sub in ast[1]:
            scoped[name] = _compile_query(sub, scoped)
        return _compile_query(ast[2], scoped)
    if ast[0] == "select":
        return _compile_select(ast[1], tables)
    _, stmts, ops = ast
    # standard SQL precedence: INTERSECT binds tighter than UNION/EXCEPT
    items: list[Table] = [_compile_select(s, tables) for s in stmts]
    folded: list[Table] = [items[0]]
    fold_ops: list[tuple[str, str]] = []
    for (op, mode), nxt in zip(ops, items[1:]):
        if op == "intersect":
            folded[-1] = _set_op(folded[-1], nxt, "intersect")
        else:
            fold_ops.append((op, mode))
            folded.append(nxt)
    result = folded[0]
    for (op, mode), nxt in zip(fold_ops, folded[1:]):
        if op == "except":
            result = _set_op(result, nxt, "except")
        else:
            result = result.concat_reindex(_align_columns(result, nxt))
            if mode == "distinct":
                result = _distinct(result)
    return result


def sql(query: str, **tables: Table) -> Table:
    r"""Execute a SQL query over the provided tables.

    Reference: ``pw.sql`` (`internals/sql.py:613`).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('k | v\na | 1\na | 2\nb | 5')
    >>> r = pw.sql('SELECT k, SUM(v) AS s FROM t GROUP BY k', t=t)
    >>> pw.debug.compute_and_print(r, include_id=False)
    k | s
    a | 3
    b | 5
    """
    p = _Parser(_tokenize(query.strip().rstrip(";")))
    ast = _parse_query(p)
    if p.peek()[0] != "end":
        raise SqlError(f"unexpected trailing tokens: {p.peek()!r}")
    return _compile_query(ast, tables)
