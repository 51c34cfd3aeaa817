"""Compile column-expression ASTs to per-row callables.

Parity target: ``python/pathway/internals/graph_runner/
expression_evaluator.py`` (1,124 LoC) + the engine-side ``Expression``
interpreter (``src/engine/expression.rs``).  The reference lowers every
expression into a Rust expression tree evaluated per batch; here we compile
to a Python closure evaluated per row, with the same semantics:

* ``Value::Error`` poisoning — any Error operand makes the result Error
  (error.rs / dataflow.rs:582-673).
* None propagation in arithmetic/comparisons mirrors the reference's
  optional-type rules (operands must be unwrapped; at runtime None yields
  None rather than raising, matching pathway's lenient runtime path).
"""

from __future__ import annotations

import math
from typing import Any, Callable

from pathway_tpu_torch.engine.types import ERROR, Error, Json, Pointer, hash_values
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnBinaryOpExpression,
    ColumnConstExpression,
    ColumnExpression,
    ColumnReference,
    ColumnUnaryOpExpression,
    ConvertExpression,
    DeclareTypeExpression,
    FillErrorExpression,
    IfElseExpression,
    IsNoneExpression,
    IsNotNoneExpression,
    MakeTupleExpression,
    MethodCallExpression,
    PointerExpression,
    ReducerExpression,
    RequireExpression,
    SequenceGetExpression,
    UnwrapExpression,
)
from pathway_tpu_torch.internals import dtype as dt

RowFn = Callable[[int, tuple], Any]


class EvalError(Exception):
    pass


def _is_err(v) -> bool:
    return isinstance(v, Error)


_CMP_NONE_OK = {"==", "!="}


def _binop(op: str, lv, rv):
    if _is_err(lv) or _is_err(rv):
        return ERROR
    if op == "==":
        return lv == rv
    if op == "!=":
        return lv != rv
    if lv is None or rv is None:
        if op in ("&", "|"):
            pass  # fall through: bool ops on None are errors below
        return None
    try:
        if op == "+":
            if isinstance(lv, Json) or isinstance(rv, Json):
                return ERROR
            return lv + rv
        if op == "-":
            return lv - rv
        if op == "*":
            return lv * rv
        if op == "/":
            if isinstance(lv, int) and isinstance(rv, int):
                if rv == 0:
                    return ERROR
                return lv / rv
            if isinstance(rv, (int, float)) and rv == 0:
                return ERROR
            return lv / rv
        if op == "//":
            if rv == 0:
                return ERROR
            return lv // rv
        if op == "%":
            if isinstance(rv, (int, float)) and rv == 0:
                return ERROR
            return lv % rv
        if op == "**":
            return lv**rv
        if op == "<":
            return lv < rv
        if op == "<=":
            return lv <= rv
        if op == ">":
            return lv > rv
        if op == ">=":
            return lv >= rv
        if op == "&":
            return lv & rv
        if op == "|":
            return lv | rv
        if op == "^":
            return lv ^ rv
        if op == "@":
            return lv @ rv
    except (TypeError, ValueError, ZeroDivisionError, OverflowError):
        return ERROR
    raise EvalError(f"unknown operator {op}")


class Binder:
    """Resolves ColumnReferences to accessors for a given evaluation site."""

    def resolve(self, ref: ColumnReference) -> RowFn:
        raise NotImplementedError

    def resolve_dtype(self, ref: ColumnReference) -> dt.DType:
        return dt.ANY


def compile_expr(e: ColumnExpression, binder: Binder) -> RowFn:
    if isinstance(e, ColumnConstExpression):
        v = e._val
        return lambda key, row: v

    if isinstance(e, ColumnReference):
        return binder.resolve(e)

    if isinstance(e, ColumnBinaryOpExpression):
        lf = compile_expr(e._left, binder)
        rf = compile_expr(e._right, binder)
        op = e._op
        return lambda key, row: _binop(op, lf(key, row), rf(key, row))

    if isinstance(e, ColumnUnaryOpExpression):
        f = compile_expr(e._expr, binder)
        if e._op == "-":

            def neg(key, row):
                v = f(key, row)
                if v is None or _is_err(v):
                    return v
                try:
                    return -v
                except TypeError:
                    return ERROR

            return neg
        if e._op == "~":

            def inv(key, row):
                v = f(key, row)
                if v is None or _is_err(v):
                    return v
                if isinstance(v, bool):
                    return not v
                return ~v

            return inv
        raise EvalError(f"unknown unary {e._op}")

    if isinstance(e, AsyncApplyExpression):
        # compiled specially by the table layer (AsyncApplyNode); when reached
        # here (e.g. nested), run the coroutine synchronously.
        fns = [compile_expr(a, binder) for a in e._args]
        kfns = {k: compile_expr(v, binder) for k, v in e._kwargs.items()}
        fun = e._fun

        def apply_async_sync(key, row):
            import asyncio

            args = [f(key, row) for f in fns]
            kwargs = {k: f(key, row) for k, f in kfns.items()}
            if any(_is_err(a) for a in args) or any(_is_err(v) for v in kwargs.values()):
                return ERROR
            try:
                return asyncio.run(fun(*args, **kwargs))
            except Exception:
                return ERROR

        return apply_async_sync

    if isinstance(e, ApplyExpression):
        fns = [compile_expr(a, binder) for a in e._args]
        kfns = {k: compile_expr(v, binder) for k, v in e._kwargs.items()}
        fun = e._fun
        propagate_none = e._propagate_none
        err_cls = Error

        if not kfns and len(fns) == 1:
            # the dominant shape (one positional arg, no kwargs): no list
            # build, no generator-based error scans — this wrapper runs
            # once per row on every Apply in a pipeline
            f0 = fns[0]

            def apply_fn1(key, row):
                a = f0(key, row)
                if isinstance(a, err_cls):
                    return ERROR
                if propagate_none and a is None:
                    return None
                try:
                    return fun(a)
                except Exception:
                    from pathway_tpu_torch.internals import config as _cfg

                    if _cfg.get_config().terminate_on_error:
                        raise
                    return ERROR

            return apply_fn1

        if not kfns:

            def apply_fn_pos(key, row):
                args = [f(key, row) for f in fns]
                for a in args:
                    if isinstance(a, err_cls):
                        return ERROR
                if propagate_none:
                    for a in args:
                        if a is None:
                            return None
                try:
                    return fun(*args)
                except Exception:
                    from pathway_tpu_torch.internals import config as _cfg

                    if _cfg.get_config().terminate_on_error:
                        raise
                    return ERROR

            return apply_fn_pos

        def apply_fn(key, row):
            args = [f(key, row) for f in fns]
            kwargs = {k: f(key, row) for k, f in kfns.items()}
            if any(_is_err(a) for a in args) or any(_is_err(v) for v in kwargs.values()):
                return ERROR
            if propagate_none and any(a is None for a in args):
                return None
            try:
                return fun(*args, **kwargs)
            except Exception as exc:
                from pathway_tpu_torch.internals import config as _cfg

                if _cfg.get_config().terminate_on_error:
                    raise
                return ERROR

        return apply_fn

    if isinstance(e, CastExpression):
        f = compile_expr(e._expr, binder)
        target = e._return_type.strip_optional()

        def cast_fn(key, row):
            v = f(key, row)
            if v is None or _is_err(v):
                return v
            try:
                if target is dt.INT:
                    return int(v)
                if target is dt.FLOAT:
                    return float(v)
                if target is dt.BOOL:
                    return bool(v)
                if target is dt.STR:
                    return str(v)
                return v
            except (TypeError, ValueError):
                return ERROR

        return cast_fn

    if isinstance(e, ConvertExpression):
        f = compile_expr(e._expr, binder)
        target = e._return_type.strip_optional()
        unwrap_flag = e._unwrap

        def convert_fn(key, row):
            v = f(key, row)
            if _is_err(v):
                return v
            if isinstance(v, Json):
                v = v.value
            if v is None:
                if unwrap_flag:
                    return ERROR
                return None
            try:
                if target is dt.INT:
                    if isinstance(v, bool):
                        return int(v)
                    if isinstance(v, (int, float)):
                        if isinstance(v, float) and v != int(v):
                            return ERROR
                        return int(v)
                    return ERROR
                if target is dt.FLOAT:
                    if isinstance(v, bool):
                        return float(v)
                    if isinstance(v, (int, float)):
                        return float(v)
                    return ERROR
                if target is dt.BOOL:
                    return v if isinstance(v, bool) else ERROR
                if target is dt.STR:
                    return v if isinstance(v, str) else ERROR
            except (TypeError, ValueError):
                return ERROR
            return ERROR

        return convert_fn

    if isinstance(e, DeclareTypeExpression):
        return compile_expr(e._expr, binder)

    if isinstance(e, CoalesceExpression):
        fns = [compile_expr(a, binder) for a in e._args]

        def coalesce_fn(key, row):
            for f in fns:
                v = f(key, row)
                if _is_err(v):
                    return v
                if v is not None:
                    return v
            return None

        return coalesce_fn

    if isinstance(e, RequireExpression):
        vf = compile_expr(e._val, binder)
        fns = [compile_expr(a, binder) for a in e._args]

        def require_fn(key, row):
            for f in fns:
                v = f(key, row)
                if _is_err(v):
                    return v
                if v is None:
                    return None
            return vf(key, row)

        return require_fn

    if isinstance(e, IfElseExpression):
        cf = compile_expr(e._if, binder)
        tf = compile_expr(e._then, binder)
        ef = compile_expr(e._else, binder)

        def if_else_fn(key, row):
            c = cf(key, row)
            if _is_err(c):
                return c
            if c is None:
                return None
            return tf(key, row) if c else ef(key, row)

        return if_else_fn

    if isinstance(e, IsNotNoneExpression):
        f = compile_expr(e._expr, binder)
        return lambda key, row: (
            ERROR if _is_err(v := f(key, row)) else v is not None
        )

    if isinstance(e, IsNoneExpression):
        f = compile_expr(e._expr, binder)
        return lambda key, row: (
            ERROR if _is_err(v := f(key, row)) else v is None
        )

    if isinstance(e, MakeTupleExpression):
        fns = [compile_expr(a, binder) for a in e._args]

        def make_tuple_fn(key, row):
            vals = tuple(f(key, row) for f in fns)
            if any(_is_err(v) for v in vals):
                return ERROR
            return vals

        return make_tuple_fn

    if isinstance(e, SequenceGetExpression):
        objf = compile_expr(e._obj, binder)
        idxf = compile_expr(e._index, binder)
        deff = compile_expr(e._default, binder)
        checked = e._check_if_exists

        def get_fn(key, row):
            obj = objf(key, row)
            idx = idxf(key, row)
            if _is_err(obj) or _is_err(idx):
                return ERROR
            if obj is None:
                return None
            try:
                if isinstance(obj, Json):
                    inner = obj.value
                    if isinstance(inner, dict):
                        if checked:
                            if idx in inner:
                                return Json(inner[idx])
                            return deff(key, row)
                        return Json(inner[idx])
                    if isinstance(inner, (list, str)):
                        if checked:
                            if isinstance(idx, int) and -len(inner) <= idx < len(inner):
                                return Json(inner[idx])
                            return deff(key, row)
                        return Json(inner[idx])
                    if checked:
                        return deff(key, row)
                    return ERROR
                return obj[idx]
            except (KeyError, IndexError, TypeError):
                if checked:
                    return deff(key, row)
                return ERROR

        return get_fn

    if isinstance(e, MethodCallExpression):
        fns = [compile_expr(a, binder) for a in e._args]
        kfns = {k: compile_expr(v, binder) for k, v in e._kwargs.items()}
        fun = e._fun
        propagate_none = e._propagate_none

        def method_fn(key, row):
            args = [f(key, row) for f in fns]
            if any(_is_err(a) for a in args):
                return ERROR
            if propagate_none and args and args[0] is None:
                return None
            kwargs = {k: f(key, row) for k, f in kfns.items()}
            try:
                return fun(*args, **kwargs)
            except Exception:
                return ERROR

        return method_fn

    if isinstance(e, UnwrapExpression):
        f = compile_expr(e._expr, binder)

        def unwrap_fn(key, row):
            v = f(key, row)
            if v is None:
                return ERROR
            return v

        return unwrap_fn

    if isinstance(e, FillErrorExpression):
        f = compile_expr(e._expr, binder)
        rf = compile_expr(e._replacement, binder)

        def fill_error_fn(key, row):
            v = f(key, row)
            if _is_err(v):
                return rf(key, row)
            return v

        return fill_error_fn

    if isinstance(e, PointerExpression):
        fns = [compile_expr(a, binder) for a in e._args]
        optional = e._optional
        instance_f = (
            compile_expr(expr_mod._wrap(e._instance), binder)
            if e._instance is not None
            else None
        )

        def pointer_fn(key, row):
            vals = [f(key, row) for f in fns]
            if any(_is_err(v) for v in vals):
                return ERROR
            if optional and any(v is None for v in vals):
                return None
            if instance_f is not None:
                vals.append(instance_f(key, row))
            return Pointer(hash_values(vals))

        return pointer_fn

    if isinstance(e, ReducerExpression):
        raise EvalError(
            "reducer expression used outside reduce(): "
            f"{e!r} — reducers are only valid inside groupby(...).reduce(...)"
        )

    raise EvalError(f"cannot compile expression {e!r} of type {type(e)}")
