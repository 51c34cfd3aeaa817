"""Metadata filter expressions for index queries.

Counterpart of ``pathway_tpu/stdlib/indexing/filters.py``, copied so that
the port imports nothing of the JAX package.  Supports ``==``/``!=``/order
comparisons on dotted paths, ``contains``, ``globmatch``, ``starts_with``,
``ends_with`` and ``&&``/``||``/``!``.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Any

from pathway_tpu_torch.engine.types import Json


def _resolve_path(metadata: Any, path: str) -> Any:
    if isinstance(metadata, Json):
        metadata = metadata.value
    cur = metadata
    for part in path.split("."):
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    if isinstance(cur, Json):
        cur = cur.value
    return cur


_TOKEN = re.compile(
    r"\s*(&&|\|\||==|!=|>=|<=|>|<|\(|\)|!|,|'[^']*'|\"[^\"]*\"|[\w.`$@-]+)"
)


def _tokenize(s: str) -> list[str]:
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m:
            raise ValueError(f"bad filter syntax near {s[i:]!r}")
        out.append(m.group(1))
        i = m.end()
    return out


class _Parser:
    def __init__(self, tokens: list[str], metadata: Any):
        self.toks = tokens
        self.i = 0
        self.metadata = metadata

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def parse_or(self):
        v = self.parse_and()
        while self.peek() == "||":
            self.next()
            rhs = self.parse_and()
            v = v or rhs
        return v

    def parse_and(self):
        v = self.parse_not()
        while self.peek() == "&&":
            self.next()
            rhs = self.parse_not()
            v = v and rhs
        return v

    def parse_not(self):
        if self.peek() == "!":
            self.next()
            return not self.parse_not()
        return self.parse_cmp()

    def _value(self, tok: str):
        if tok and tok[0] in "'\"":
            return tok[1:-1]
        if tok == "null":
            return None
        if tok in ("true", "false"):
            return tok == "true"
        try:
            return int(tok)
        except ValueError:
            pass
        try:
            return float(tok)
        except ValueError:
            pass
        return _resolve_path(self.metadata, tok.strip("`"))

    def parse_cmp(self):
        if self.peek() == "(":
            self.next()
            v = self.parse_or()
            if self.next() != ")":
                raise ValueError("expected )")
            return v
        tok = self.next()
        if tok in ("contains", "globmatch", "starts_with", "ends_with"):
            if self.next() != "(":
                raise ValueError("expected (")
            a = self._value(self.next())
            if self.next() != ",":
                raise ValueError("expected ,")
            b = self._value(self.next())
            if self.next() != ")":
                raise ValueError("expected )")
            if tok == "contains":
                try:
                    return b in a if a is not None else False
                except TypeError:
                    return False
            if tok == "globmatch":
                return fnmatch.fnmatch(str(b or ""), str(a or ""))
            if tok == "starts_with":
                return str(a or "").startswith(str(b or ""))
            return str(a or "").endswith(str(b or ""))
        left = self._value(tok)
        op = self.peek()
        if op in ("==", "!=", ">", "<", ">=", "<="):
            self.next()
            right = self._value(self.next())
            try:
                if op == "==":
                    return left == right
                if op == "!=":
                    return left != right
                if op == ">":
                    return left > right
                if op == "<":
                    return left < right
                if op == ">=":
                    return left >= right
                return left <= right
            except TypeError:
                return False
        return bool(left)


def metadata_matches(filter_expression: str | None, metadata: Any) -> bool:
    """Evaluate a filter expression against one document's metadata
    (the JMESPath-style filter language of DocumentStore queries).

    Example:

    >>> from pathway_tpu_torch.stdlib.indexing.filters import metadata_matches
    >>> meta = {"path": "/docs/a.pdf", "owner": "kim", "size": 4096}
    >>> metadata_matches("owner == 'kim'", meta)
    True
    >>> metadata_matches("size > 10000", meta)
    False
    >>> metadata_matches("globmatch('/docs/*.pdf', path) && owner == 'kim'", meta)
    True
    >>> metadata_matches(None, meta)  # no filter matches everything
    True
    """
    if filter_expression is None or filter_expression == "":
        return True
    if isinstance(filter_expression, Json):
        filter_expression = filter_expression.value
    try:
        return bool(_Parser(_tokenize(str(filter_expression)), metadata).parse_or())
    except ValueError:
        return False


__all__ = ["metadata_matches"]
