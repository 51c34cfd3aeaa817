"""``expr.str.*`` string method namespace.

Parity target: ``python/pathway/internals/expressions/string.py``.
"""

from __future__ import annotations

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import ColumnExpression, MethodCallExpression


class StringNamespace:
    r"""``col.str`` — string operations on column expressions.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> t = pw.debug.table_from_markdown('w\nHello World\nbye')
    >>> r = t.select(
    ...     up=pw.this.w.str.upper(),
    ...     n=pw.this.w.str.len(),
    ...     first=pw.this.w.str.split(' ').get(0, default=''),
    ... )
    >>> pw.debug.compute_and_print(r, include_id=False)
    up          | n  | first
    BYE         | 3  | bye
    HELLO WORLD | 11 | Hello
    """
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _m(self, name, fun, ret, *args):
        return MethodCallExpression(f"str.{name}", fun, ret, [self._expr, *args])

    def lower(self):
        return self._m("lower", str.lower, dt.STR)

    def upper(self):
        return self._m("upper", str.upper, dt.STR)

    def reversed(self):
        return self._m("reversed", lambda s: s[::-1], dt.STR)

    def strip(self, chars=None):
        return self._m("strip", lambda s, c: s.strip(c), dt.STR, chars)

    def title(self):
        return self._m("title", str.title, dt.STR)

    def swap_case(self):
        return self._m("swap_case", str.swapcase, dt.STR)

    def len(self):
        return self._m("len", len, dt.INT)

    def count(self, sub, start=None, end=None):
        return self._m(
            "count",
            lambda s, x, b, e: s.count(x, b, e if e is not None else len(s)),
            dt.INT,
            sub,
            start if start is not None else 0,
            end,
        )

    def find(self, sub, start=None, end=None):
        return self._m(
            "find",
            lambda s, x, b, e: s.find(x, b, e if e is not None else len(s)),
            dt.INT,
            sub,
            start if start is not None else 0,
            end,
        )

    def rfind(self, sub, start=None, end=None):
        return self._m(
            "rfind",
            lambda s, x, b, e: s.rfind(x, b, e if e is not None else len(s)),
            dt.INT,
            sub,
            start if start is not None else 0,
            end,
        )

    def startswith(self, prefix):
        return self._m("startswith", lambda s, p: s.startswith(p), dt.BOOL, prefix)

    def endswith(self, suffix):
        return self._m("endswith", lambda s, p: s.endswith(p), dt.BOOL, suffix)

    def removeprefix(self, prefix):
        return self._m("removeprefix", lambda s, p: s.removeprefix(p), dt.STR, prefix)

    def removesuffix(self, suffix):
        return self._m("removesuffix", lambda s, p: s.removesuffix(p), dt.STR, suffix)

    def replace(self, old_value, new_value, count=-1):
        return self._m(
            "replace", lambda s, o, n, c: s.replace(o, n, c), dt.STR, old_value, new_value, count
        )

    def split(self, delimiter=None):
        return self._m(
            "split", lambda s, d: tuple(s.split(d)), dt.List(dt.STR), delimiter
        )

    def slice(self, start, end):
        return self._m("slice", lambda s, b, e: s[b:e], dt.STR, start, end)

    def parse_int(self, optional: bool = False):
        def impl(s):
            try:
                return int(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return self._m("parse_int", impl, dt.Optional(dt.INT) if optional else dt.INT)

    def parse_float(self, optional: bool = False):
        def impl(s):
            try:
                return float(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return self._m("parse_float", impl, dt.Optional(dt.FLOAT) if optional else dt.FLOAT)

    def parse_bool(self, true_values=("on", "true", "yes", "1"), false_values=("off", "false", "no", "0"), optional: bool = False):
        def impl(s):
            low = s.lower()
            if low in true_values:
                return True
            if low in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return self._m("parse_bool", impl, dt.Optional(dt.BOOL) if optional else dt.BOOL)

    def to_datetime(self, fmt, contains_timezone: bool | None = None):
        import datetime as _dt

        ret = dt.DATE_TIME_UTC if contains_timezone else dt.DATE_TIME_NAIVE
        return self._m("to_datetime", lambda s, f: _dt.datetime.strptime(s, f), ret, fmt)
