"""Column expression DSL.

Parity target: ``python/pathway/internals/expression.py``
(1,179 LoC) plus the ``expressions/{date_time,numerical,string}.py`` method
namespaces.  Expressions are passive ASTs; the engine's expression evaluator
compiles them to per-row callables (and, for device-bound columns, to jax
functions).  Operator overloading, ``pw.this`` desugaring, None- and
Error-propagation semantics follow the reference.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine.types import ERROR, Error, Json, Pointer
from pathway_tpu_torch.internals import dtype as dt


class ColumnExpression:
    """Base class of all column expressions."""

    _dtype_hint: dt.DType | None = None

    def __call__(self, *args, **kwargs):
        """Invoke a column of callables (row-transformer ``@method`` columns;
        the reference lowers this via ``method_call_transformer``,
        row_transformer.py:80)."""
        return ApplyExpression(
            lambda f, *a, **kw: f(*a, **kw), None, self, *args, **kwargs
        )

    # -- arithmetic --
    def __add__(self, other):
        return ColumnBinaryOpExpression("+", self, other)

    def __radd__(self, other):
        return ColumnBinaryOpExpression("+", other, self)

    def __sub__(self, other):
        return ColumnBinaryOpExpression("-", self, other)

    def __rsub__(self, other):
        return ColumnBinaryOpExpression("-", other, self)

    def __mul__(self, other):
        return ColumnBinaryOpExpression("*", self, other)

    def __rmul__(self, other):
        return ColumnBinaryOpExpression("*", other, self)

    def __truediv__(self, other):
        return ColumnBinaryOpExpression("/", self, other)

    def __rtruediv__(self, other):
        return ColumnBinaryOpExpression("/", other, self)

    def __floordiv__(self, other):
        return ColumnBinaryOpExpression("//", self, other)

    def __rfloordiv__(self, other):
        return ColumnBinaryOpExpression("//", other, self)

    def __mod__(self, other):
        return ColumnBinaryOpExpression("%", self, other)

    def __rmod__(self, other):
        return ColumnBinaryOpExpression("%", other, self)

    def __pow__(self, other):
        return ColumnBinaryOpExpression("**", self, other)

    def __rpow__(self, other):
        return ColumnBinaryOpExpression("**", other, self)

    def __matmul__(self, other):
        return ColumnBinaryOpExpression("@", self, other)

    def __rmatmul__(self, other):
        return ColumnBinaryOpExpression("@", other, self)

    def __neg__(self):
        return ColumnUnaryOpExpression("-", self)

    def __abs__(self):
        return MethodCallExpression("abs", abs, dt.ANY, [self])

    # -- comparison --
    def __eq__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("==", self, other)

    def __ne__(self, other):  # type: ignore[override]
        return ColumnBinaryOpExpression("!=", self, other)

    def __lt__(self, other):
        return ColumnBinaryOpExpression("<", self, other)

    def __le__(self, other):
        return ColumnBinaryOpExpression("<=", self, other)

    def __gt__(self, other):
        return ColumnBinaryOpExpression(">", self, other)

    def __ge__(self, other):
        return ColumnBinaryOpExpression(">=", self, other)

    # -- boolean / bitwise --
    def __and__(self, other):
        return ColumnBinaryOpExpression("&", self, other)

    def __rand__(self, other):
        return ColumnBinaryOpExpression("&", other, self)

    def __or__(self, other):
        return ColumnBinaryOpExpression("|", self, other)

    def __ror__(self, other):
        return ColumnBinaryOpExpression("|", other, self)

    def __xor__(self, other):
        return ColumnBinaryOpExpression("^", self, other)

    def __rxor__(self, other):
        return ColumnBinaryOpExpression("^", other, self)

    def __invert__(self):
        return ColumnUnaryOpExpression("~", self)

    def __hash__(self):
        return object.__hash__(self)

    def __bool__(self):
        raise RuntimeError(
            "Cannot use a Pathway expression as a boolean; "
            "use & | ~ instead of and/or/not"
        )

    # -- indexing / methods --
    def __getitem__(self, item):
        return SequenceGetExpression(self, item, check_if_exists=False)

    def get(self, index, default=None):
        return SequenceGetExpression(self, index, default=default, check_if_exists=True)

    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def as_int(self, unwrap: bool = False, **kw):
        return ConvertExpression(dt.INT, self, unwrap=unwrap)

    def as_float(self, unwrap: bool = False, **kw):
        return ConvertExpression(dt.FLOAT, self, unwrap=unwrap)

    def as_str(self, unwrap: bool = False, **kw):
        return ConvertExpression(dt.STR, self, unwrap=unwrap)

    def as_bool(self, unwrap: bool = False, **kw):
        return ConvertExpression(dt.BOOL, self, unwrap=unwrap)

    def to_string(self):
        return MethodCallExpression(
            "to_string", lambda v: repr(v) if isinstance(v, Json) else str(v), dt.STR, [self]
        )

    # namespaces
    @property
    def dt(self):
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def num(self):
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    @property
    def str(self):
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    # -- internals --
    def _sub_expressions(self) -> Iterable["ColumnExpression"]:
        return ()

    def _substitute(self, mapping) -> "ColumnExpression":
        """Rebuild with substituted sub-expressions (desugaring)."""
        return self

    def _infer_dtype(self, resolver: Callable[["ColumnReference"], dt.DType]) -> dt.DType:
        return dt.ANY


ColumnExpressionOrValue = Any


def _wrap(value: ColumnExpressionOrValue) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ColumnConstExpression(value)


class ColumnConstExpression(ColumnExpression):
    __slots__ = ("_val",)

    def __init__(self, val: Any):
        self._val = val

    def __repr__(self):
        return repr(self._val)

    def _infer_dtype(self, resolver):
        return dt.dtype_of_value(self._val)


class ColumnReference(ColumnExpression):
    """``table.colname`` / ``pw.this.colname`` — a reference to a column."""

    __slots__ = ("_table", "_name")

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"<{self._table!r}>.{self._name}"

    def _substitute(self, mapping):
        new_table = mapping.get(id(self._table), self._table)
        if new_table is not self._table:
            return ColumnReference(new_table, self._name)
        return self

    def _infer_dtype(self, resolver):
        return resolver(self)


class ColumnBinaryOpExpression(ColumnExpression):
    __slots__ = ("_op", "_left", "_right")

    def __init__(self, op: str, left, right):
        self._op = op
        self._left = _wrap(left)
        self._right = _wrap(right)

    def __repr__(self):
        return f"({self._left!r} {self._op} {self._right!r})"

    def _sub_expressions(self):
        return (self._left, self._right)

    def _substitute(self, mapping):
        return ColumnBinaryOpExpression(
            self._op, self._left._substitute(mapping), self._right._substitute(mapping)
        )

    def _infer_dtype(self, resolver):
        lt = self._left._infer_dtype(resolver)
        rt = self._right._infer_dtype(resolver)
        op = self._op
        if op in ("==", "!=", "<", "<=", ">", ">="):
            return dt.BOOL
        if op in ("&", "|", "^"):
            if lt is dt.INT and rt is dt.INT:
                return dt.INT
            return dt.BOOL
        lt_b, rt_b = lt.strip_optional(), rt.strip_optional()
        optional = lt.is_optional() or rt.is_optional()

        def opt(t):
            return dt.Optional(t) if optional and t is not dt.ANY else t

        if op == "/":
            if lt_b in (dt.INT, dt.FLOAT) and rt_b in (dt.INT, dt.FLOAT):
                return opt(dt.FLOAT)
            if lt_b is dt.DURATION:
                return opt(dt.FLOAT if rt_b is dt.DURATION else dt.DURATION)
        if op == "//":
            if lt_b is dt.INT and rt_b is dt.INT:
                return opt(dt.INT)
            if lt_b is dt.DURATION and rt_b is dt.DURATION:
                return opt(dt.INT)
        if op in ("+", "-", "*", "%", "**"):
            if lt_b is dt.FLOAT or rt_b is dt.FLOAT:
                if lt_b in (dt.INT, dt.FLOAT) and rt_b in (dt.INT, dt.FLOAT):
                    return opt(dt.FLOAT)
            if lt_b is dt.INT and rt_b is dt.INT:
                return opt(dt.INT)
            if lt_b is dt.STR and op in ("+", "*"):
                return opt(dt.STR)
            if lt_b in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                if op == "-" and rt_b is lt_b:
                    return opt(dt.DURATION)
                if rt_b is dt.DURATION:
                    return opt(lt_b)
            if lt_b is dt.DURATION:
                if op == "+" and rt_b in (dt.DATE_TIME_NAIVE, dt.DATE_TIME_UTC):
                    return opt(rt_b)
                if rt_b is dt.DURATION and op in ("+", "-"):
                    return opt(dt.DURATION)
                if rt_b is dt.INT and op in ("*",):
                    return opt(dt.DURATION)
            if isinstance(lt_b, dt._Array) or isinstance(rt_b, dt._Array):
                return dt.ANY_ARRAY
            if lt_b is dt.ANY_TUPLE or rt_b is dt.ANY_TUPLE or isinstance(lt_b, dt._Tuple):
                if op == "+":
                    return dt.ANY_TUPLE
        if op == "@":
            return dt.ANY_ARRAY
        return dt.ANY


class ColumnUnaryOpExpression(ColumnExpression):
    __slots__ = ("_op", "_expr")

    def __init__(self, op: str, expr):
        self._op = op
        self._expr = _wrap(expr)

    def __repr__(self):
        return f"{self._op}{self._expr!r}"

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        return ColumnUnaryOpExpression(self._op, self._expr._substitute(mapping))

    def _infer_dtype(self, resolver):
        if self._op == "~":
            return dt.BOOL
        return self._expr._infer_dtype(resolver)


class ReducerExpression(ColumnExpression):
    """A reducer applied inside groupby().reduce() — e.g. pw.reducers.sum(x)."""

    __slots__ = ("_reducer", "_args", "_kwargs")

    def __init__(self, reducer, *args, **kwargs):
        self._reducer = reducer
        self._args = tuple(_wrap(a) for a in args)
        self._kwargs = kwargs

    def __repr__(self):
        return f"pw.reducers.{self._reducer.name}({', '.join(map(repr, self._args))})"

    def _sub_expressions(self):
        return self._args

    def _substitute(self, mapping):
        new = ReducerExpression(self._reducer)
        new._args = tuple(a._substitute(mapping) for a in self._args)
        new._kwargs = self._kwargs
        return new

    def _infer_dtype(self, resolver):
        return self._reducer.result_dtype(
            [a._infer_dtype(resolver) for a in self._args]
        )


class ApplyExpression(ColumnExpression):
    __slots__ = ("_fun", "_return_type", "_args", "_kwargs", "_propagate_none", "_deterministic", "_max_batch_size")

    def __init__(
        self,
        fun: Callable,
        return_type,
        *args,
        _propagate_none: bool = False,
        _deterministic: bool = True,
        _max_batch_size: int | None = None,
        **kwargs,
    ):
        self._fun = fun
        self._return_type = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._args = tuple(_wrap(a) for a in args)
        self._kwargs = {k: _wrap(v) for k, v in kwargs.items()}
        self._propagate_none = _propagate_none
        self._deterministic = _deterministic
        self._max_batch_size = _max_batch_size

    def __repr__(self):
        return f"pw.apply({getattr(self._fun, '__name__', self._fun)!r}, ...)"

    def _sub_expressions(self):
        return self._args + tuple(self._kwargs.values())

    def _substitute(self, mapping):
        new = type(self)(self._fun, self._return_type)
        new._args = tuple(a._substitute(mapping) for a in self._args)
        new._kwargs = {k: v._substitute(mapping) for k, v in self._kwargs.items()}
        new._propagate_none = self._propagate_none
        new._deterministic = self._deterministic
        new._max_batch_size = self._max_batch_size
        return new

    def _infer_dtype(self, resolver):
        return self._return_type


class AsyncApplyExpression(ApplyExpression):
    """Apply of an async fn — rows of a batch awaited concurrently (§3.3)."""


class FullyAsyncApplyExpression(ApplyExpression):
    """Non-blocking async apply: results arrive at later epochs (AsyncTransformer-style)."""

    autocommit_duration_ms: int | None = 100


class CastExpression(ColumnExpression):
    __slots__ = ("_return_type", "_expr")

    def __init__(self, return_type, expr):
        self._return_type = dt.wrap(return_type)
        self._expr = _wrap(expr)

    def __repr__(self):
        return f"pw.cast({self._return_type!r}, {self._expr!r})"

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        return CastExpression(self._return_type, self._expr._substitute(mapping))

    def _infer_dtype(self, resolver):
        inner = self._expr._infer_dtype(resolver)
        if inner.is_optional() and not self._return_type.is_optional():
            return dt.Optional(self._return_type)
        return self._return_type


class ConvertExpression(ColumnExpression):
    """as_int/as_float/as_str/as_bool — JSON-aware conversions."""

    __slots__ = ("_return_type", "_expr", "_unwrap")

    def __init__(self, return_type, expr, unwrap: bool = False):
        self._return_type = dt.wrap(return_type)
        self._expr = _wrap(expr)
        self._unwrap = unwrap

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        return ConvertExpression(self._return_type, self._expr._substitute(mapping), self._unwrap)

    def _infer_dtype(self, resolver):
        return self._return_type if self._unwrap else dt.Optional(self._return_type)


class DeclareTypeExpression(ColumnExpression):
    __slots__ = ("_return_type", "_expr")

    def __init__(self, return_type, expr):
        self._return_type = dt.wrap(return_type)
        self._expr = _wrap(expr)

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        return DeclareTypeExpression(self._return_type, self._expr._substitute(mapping))

    def _infer_dtype(self, resolver):
        return self._return_type


class CoalesceExpression(ColumnExpression):
    __slots__ = ("_args",)

    def __init__(self, *args):
        self._args = tuple(_wrap(a) for a in args)

    def _sub_expressions(self):
        return self._args

    def _substitute(self, mapping):
        new = CoalesceExpression()
        new._args = tuple(a._substitute(mapping) for a in self._args)
        return new

    def _infer_dtype(self, resolver):
        result: dt.DType | None = None
        for a in self._args:
            t = a._infer_dtype(resolver)
            result = t if result is None else dt.types_lca(result, t)
        if result is None:
            return dt.ANY
        # if any argument is non-optional, the result is non-optional
        if any(not a._infer_dtype(resolver).is_optional() for a in self._args):
            return dt.unoptionalize(result)
        return result


class RequireExpression(ColumnExpression):
    __slots__ = ("_val", "_args")

    def __init__(self, val, *args):
        self._val = _wrap(val)
        self._args = tuple(_wrap(a) for a in args)

    def _sub_expressions(self):
        return (self._val, *self._args)

    def _substitute(self, mapping):
        return RequireExpression(
            self._val._substitute(mapping), *[a._substitute(mapping) for a in self._args]
        )

    def _infer_dtype(self, resolver):
        return dt.Optional(self._val._infer_dtype(resolver))


class IfElseExpression(ColumnExpression):
    __slots__ = ("_if", "_then", "_else")

    def __init__(self, _if, _then, _else):
        self._if = _wrap(_if)
        self._then = _wrap(_then)
        self._else = _wrap(_else)

    def _sub_expressions(self):
        return (self._if, self._then, self._else)

    def _substitute(self, mapping):
        return IfElseExpression(
            self._if._substitute(mapping),
            self._then._substitute(mapping),
            self._else._substitute(mapping),
        )

    def _infer_dtype(self, resolver):
        return dt.types_lca(
            self._then._infer_dtype(resolver), self._else._infer_dtype(resolver)
        )


class IsNoneExpression(ColumnExpression):
    __slots__ = ("_expr",)

    def __init__(self, expr):
        self._expr = _wrap(expr)

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        # type(self): IsNotNoneExpression inherits this — substituting must
        # not collapse it into the base class
        return type(self)(self._expr._substitute(mapping))

    def _infer_dtype(self, resolver):
        return dt.BOOL


class IsNotNoneExpression(IsNoneExpression):
    pass


class MakeTupleExpression(ColumnExpression):
    __slots__ = ("_args",)

    def __init__(self, *args):
        self._args = tuple(_wrap(a) for a in args)

    def _sub_expressions(self):
        return self._args

    def _substitute(self, mapping):
        new = MakeTupleExpression()
        new._args = tuple(a._substitute(mapping) for a in self._args)
        return new

    def _infer_dtype(self, resolver):
        return dt.Tuple(*[a._infer_dtype(resolver) for a in self._args])


class SequenceGetExpression(ColumnExpression):
    __slots__ = ("_obj", "_index", "_default", "_check_if_exists")

    def __init__(self, obj, index, default=None, check_if_exists: bool = True):
        self._obj = _wrap(obj)
        self._index = _wrap(index)
        self._default = _wrap(default)
        self._check_if_exists = check_if_exists

    def _sub_expressions(self):
        return (self._obj, self._index, self._default)

    def _substitute(self, mapping):
        new = SequenceGetExpression(
            self._obj._substitute(mapping),
            self._index._substitute(mapping),
            check_if_exists=self._check_if_exists,
        )
        new._default = self._default._substitute(mapping)
        return new

    def _infer_dtype(self, resolver):
        obj_t = self._obj._infer_dtype(resolver).strip_optional()
        if obj_t is dt.JSON:
            return dt.Optional(dt.JSON) if self._check_if_exists else dt.JSON
        if isinstance(obj_t, dt._List):
            return obj_t.wrapped
        if isinstance(obj_t, dt._Tuple) and obj_t.args is not Ellipsis:
            if isinstance(self._index, ColumnConstExpression) and isinstance(
                self._index._val, int
            ):
                i = self._index._val
                if -len(obj_t.args) <= i < len(obj_t.args):
                    return obj_t.args[i]
        if obj_t is dt.STR:
            return dt.STR
        if isinstance(obj_t, dt._Array):
            return dt.ANY
        return dt.ANY


class MethodCallExpression(ColumnExpression):
    """A namespaced method (x.dt.year(), x.str.lower(), ...) with a host impl."""

    __slots__ = ("_method_name", "_fun", "_return_type", "_args", "_kwargs", "_propagate_none")

    def __init__(self, method_name: str, fun: Callable, return_type, args, kwargs=None, propagate_none=True):
        self._method_name = method_name
        self._fun = fun
        self._return_type = return_type
        self._args = tuple(_wrap(a) for a in args)
        self._kwargs = {k: _wrap(v) for k, v in (kwargs or {}).items()}
        self._propagate_none = propagate_none

    def __repr__(self):
        return f".{self._method_name}({', '.join(map(repr, self._args[1:]))})"

    def _sub_expressions(self):
        return self._args + tuple(self._kwargs.values())

    def _substitute(self, mapping):
        new = MethodCallExpression(
            self._method_name, self._fun, self._return_type, []
        )
        new._args = tuple(a._substitute(mapping) for a in self._args)
        new._kwargs = {k: v._substitute(mapping) for k, v in self._kwargs.items()}
        new._propagate_none = self._propagate_none
        return new

    def _infer_dtype(self, resolver):
        if callable(self._return_type) and not isinstance(self._return_type, dt.DType):
            return self._return_type([a._infer_dtype(resolver) for a in self._args])
        return dt.wrap(self._return_type)


class UnwrapExpression(ColumnExpression):
    __slots__ = ("_expr",)

    def __init__(self, expr):
        self._expr = _wrap(expr)

    def _sub_expressions(self):
        return (self._expr,)

    def _substitute(self, mapping):
        return UnwrapExpression(self._expr._substitute(mapping))

    def _infer_dtype(self, resolver):
        return dt.unoptionalize(self._expr._infer_dtype(resolver))


class FillErrorExpression(ColumnExpression):
    __slots__ = ("_expr", "_replacement")

    def __init__(self, expr, replacement):
        self._expr = _wrap(expr)
        self._replacement = _wrap(replacement)

    def _sub_expressions(self):
        return (self._expr, self._replacement)

    def _substitute(self, mapping):
        return FillErrorExpression(
            self._expr._substitute(mapping), self._replacement._substitute(mapping)
        )

    def _infer_dtype(self, resolver):
        return dt.types_lca(
            self._expr._infer_dtype(resolver), self._replacement._infer_dtype(resolver)
        )


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*args)`` — derive a row id."""

    __slots__ = ("_table", "_args", "_optional", "_instance")

    def __init__(self, table, *args, optional: bool = False, instance=None):
        self._table = table
        self._args = tuple(_wrap(a) for a in args)
        self._optional = optional
        self._instance = instance

    def _sub_expressions(self):
        return self._args

    def _substitute(self, mapping):
        new = PointerExpression(
            mapping.get(id(self._table), self._table), optional=self._optional
        )
        new._args = tuple(a._substitute(mapping) for a in self._args)
        new._instance = self._instance
        return new

    def _infer_dtype(self, resolver):
        return dt.Optional(dt.POINTER) if self._optional else dt.POINTER


# --- free functions (exported at pw top level) --------------------------------


def apply(fun: Callable, *args, **kwargs) -> ColumnExpression:
    """``pw.apply`` — row-wise application of a Python function."""
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fun)
    except Exception:
        pass
    ret = hints.get("return")
    return ApplyExpression(fun, ret, *args, **kwargs)


def apply_with_type(fun: Callable, ret_type, *args, **kwargs) -> ColumnExpression:
    return ApplyExpression(fun, ret_type, *args, **kwargs)


def apply_async(fun: Callable, *args, **kwargs) -> ColumnExpression:
    import typing as _t

    hints = {}
    try:
        hints = _t.get_type_hints(fun)
    except Exception:
        pass
    return AsyncApplyExpression(fun, hints.get("return"), *args, **kwargs)


def cast(target_type, expr) -> CastExpression:
    return CastExpression(target_type, expr)


def declare_type(target_type, expr) -> DeclareTypeExpression:
    return DeclareTypeExpression(target_type, expr)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *args) -> RequireExpression:
    return RequireExpression(val, *args)


def if_else(_if, _then, _else) -> IfElseExpression:
    return IfElseExpression(_if, _then, _else)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def unwrap(expr) -> UnwrapExpression:
    return UnwrapExpression(expr)


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def assert_table_has_schema(table, schema, *, allow_superset: bool = True, ignore_primary_keys: bool = True) -> None:
    table.schema.assert_matches_schema(
        schema, allow_superset=allow_superset, ignore_primary_keys=ignore_primary_keys
    )
