"""Dtype lattice for schema/type inference.

Parity target: ``python/pathway/internals/dtype.py`` (979 LoC).
Provides the same user-observable surface — singleton dtypes, ``Optional``,
``Tuple``/``List``/``Array``, conversion from Python annotations, and a least
upper bound used by type inference — without the reference's torch-style
caching metaclass machinery.
"""

from __future__ import annotations

import datetime
import types as _pytypes
import typing
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine import types as _etypes


class DType:
    """Base of all dtypes. Instances are immutable and hash-consed."""

    _cache: dict[Any, "DType"] = {}

    def is_value_compatible(self, value: Any) -> bool:
        raise NotImplementedError

    def to_python_type(self):
        return object

    @property
    def typehint(self):
        return self.to_python_type()

    def __repr__(self) -> str:
        return self.__class__.__name__

    def equivalent_to(self, other: "DType") -> bool:
        return self == other

    def is_subclass_of(self, other: "DType") -> bool:
        if other is ANY or self == other:
            return True
        if isinstance(other, _Optional):
            if self is NONE:
                return True
            inner = self.strip_optional()
            return inner.is_subclass_of(other.wrapped) and (
                not isinstance(self, _Optional) or True
            )
        if self is INT and other is FLOAT:
            return True
        if isinstance(self, _Tuple) and isinstance(other, _Tuple):
            if other.args is Ellipsis:
                return True
            if self.args is Ellipsis:
                return False
            if len(self.args) != len(other.args):
                return False
            return all(a.is_subclass_of(b) for a, b in zip(self.args, other.args))
        return False

    def strip_optional(self) -> "DType":
        return self

    def is_optional(self) -> bool:
        return isinstance(self, _Optional) or self is ANY or self is NONE


class _SimpleDType(DType):
    __slots__ = ("name", "_ptype", "_compat")

    def __new__(cls, name: str, ptype, compat):
        key = ("simple", name)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.name = name
            obj._ptype = ptype
            obj._compat = compat
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return self.name

    def to_python_type(self):
        return self._ptype

    def is_value_compatible(self, value: Any) -> bool:
        return self._compat(value)


ANY = _SimpleDType("ANY", object, lambda v: True)
NONE = _SimpleDType("NONE", type(None), lambda v: v is None)
INT = _SimpleDType("INT", int, lambda v: isinstance(v, (int, np.integer)) and not isinstance(v, bool))
FLOAT = _SimpleDType(
    "FLOAT", float, lambda v: isinstance(v, (int, float, np.floating, np.integer)) and not isinstance(v, bool)
)
BOOL = _SimpleDType("BOOL", bool, lambda v: isinstance(v, (bool, np.bool_)))
STR = _SimpleDType("STR", str, lambda v: isinstance(v, str))
BYTES = _SimpleDType("BYTES", bytes, lambda v: isinstance(v, bytes))
POINTER = _SimpleDType("POINTER", _etypes.Pointer, lambda v: isinstance(v, _etypes.Pointer))
DATE_TIME_NAIVE = _SimpleDType(
    "DATE_TIME_NAIVE",
    datetime.datetime,
    lambda v: isinstance(v, datetime.datetime) and v.tzinfo is None,
)
DATE_TIME_UTC = _SimpleDType(
    "DATE_TIME_UTC",
    datetime.datetime,
    lambda v: isinstance(v, datetime.datetime) and v.tzinfo is not None,
)
DURATION = _SimpleDType("DURATION", datetime.timedelta, lambda v: isinstance(v, datetime.timedelta))
JSON = _SimpleDType("JSON", _etypes.Json, lambda v: isinstance(v, _etypes.Json))
ERROR = _SimpleDType("ERROR", _etypes.Error, lambda v: isinstance(v, _etypes.Error))
PY_OBJECT_WRAPPER = _SimpleDType(
    "PY_OBJECT_WRAPPER", _etypes.PyObjectWrapper, lambda v: isinstance(v, _etypes.PyObjectWrapper)
)
FUTURE = _SimpleDType("FUTURE", object, lambda v: True)  # pending async results


class _Optional(DType):
    __slots__ = ("wrapped",)

    def __new__(cls, wrapped: DType):
        if isinstance(wrapped, _Optional) or wrapped in (ANY, NONE):
            return wrapped
        key = ("optional", wrapped)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.wrapped = wrapped
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return f"Optional({self.wrapped!r})"

    def to_python_type(self):
        return typing.Optional[self.wrapped.to_python_type()]

    def is_value_compatible(self, value: Any) -> bool:
        return value is None or self.wrapped.is_value_compatible(value)

    def strip_optional(self) -> DType:
        return self.wrapped


def Optional(wrapped: DType) -> DType:  # noqa: N802  (mirrors dt.Optional)
    return _Optional(wrapped)


class _Pointer(DType):
    """Typed pointer Pointer[S] — equivalent to POINTER for runtime purposes."""

    __slots__ = ("schema",)

    def __new__(cls, schema=None):
        key = ("pointer", schema)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.schema = schema
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return "POINTER" if self.schema is None else f"Pointer({self.schema.__name__})"

    def to_python_type(self):
        return _etypes.Pointer

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, _etypes.Pointer)

    def is_subclass_of(self, other: DType) -> bool:
        if other is POINTER or isinstance(other, _Pointer):
            return True
        return super().is_subclass_of(other)


def Pointer(schema=None) -> DType:  # noqa: N802
    if schema is None:
        return POINTER
    return _Pointer(schema)


class _Tuple(DType):
    __slots__ = ("args",)

    def __new__(cls, args):
        key = ("tuple", args if args is Ellipsis else tuple(args))
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.args = args if args is Ellipsis else tuple(args)
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        if self.args is Ellipsis:
            return "Tuple(...)"
        return f"Tuple({', '.join(map(repr, self.args))})"

    def to_python_type(self):
        return tuple

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, tuple):
            return False
        if self.args is Ellipsis:
            return True
        return len(value) == len(self.args) and all(
            a.is_value_compatible(v) for a, v in zip(self.args, value)
        )


def Tuple(*args) -> DType:  # noqa: N802
    if len(args) == 1 and args[0] is Ellipsis:
        return _Tuple(Ellipsis)
    return _Tuple(tuple(wrap(a) if not isinstance(a, DType) else a for a in args))


ANY_TUPLE = _Tuple(Ellipsis)


class _List(DType):
    __slots__ = ("wrapped",)

    def __new__(cls, wrapped: DType):
        key = ("list", wrapped)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.wrapped = wrapped
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return f"List({self.wrapped!r})"

    def to_python_type(self):
        return tuple  # lists are normalized to tuples in the engine

    def is_value_compatible(self, value: Any) -> bool:
        return isinstance(value, (tuple, list)) and all(
            self.wrapped.is_value_compatible(v) for v in value
        )


def List(wrapped) -> DType:  # noqa: N802
    return _List(wrap_inner(wrapped))


class _Array(DType):
    """N-dimensional numeric array (maps to numpy arrays; tensors convert to them)."""

    __slots__ = ("n_dim", "wrapped")

    def __new__(cls, n_dim=None, wrapped=None):
        key = ("array", n_dim, wrapped)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.n_dim = n_dim
            obj.wrapped = wrapped
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return f"Array({self.n_dim}, {self.wrapped!r})"

    def to_python_type(self):
        return np.ndarray

    def is_value_compatible(self, value: Any) -> bool:
        if not isinstance(value, np.ndarray):
            # tensors quack like ndarrays (coerce() converts them)
            return isinstance(value, torch.Tensor)
        return self.n_dim is None or value.ndim == self.n_dim

    def is_subclass_of(self, other: DType) -> bool:
        if isinstance(other, _Array) and other.n_dim is None:
            return True
        return super().is_subclass_of(other)


def Array(n_dim=None, wrapped=None) -> DType:  # noqa: N802
    return _Array(n_dim, wrapped)


ANY_ARRAY = _Array(None, None)
INT_ARRAY = _Array(None, INT)
FLOAT_ARRAY = _Array(None, FLOAT)


class _Callable(DType):
    __slots__ = ("arg_types", "return_type")

    def __new__(cls, arg_types, return_type):
        key = ("callable", arg_types if arg_types is Ellipsis else tuple(arg_types), return_type)
        if key not in DType._cache:
            obj = super().__new__(cls)
            obj.arg_types = arg_types
            obj.return_type = return_type
            DType._cache[key] = obj
        return DType._cache[key]

    def __repr__(self) -> str:
        return f"Callable(..., {self.return_type!r})"

    def is_value_compatible(self, value: Any) -> bool:
        return callable(value)


def Callable(arg_types=Ellipsis, return_type=ANY) -> DType:  # noqa: N802
    return _Callable(arg_types, return_type)


# --- conversion from Python annotations --------------------------------------

_SIMPLE_FROM_PY = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    Any: ANY,
    np.ndarray: ANY_ARRAY,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    _etypes.Pointer: POINTER,
    _etypes.Json: JSON,
    _etypes.PyObjectWrapper: PY_OBJECT_WRAPPER,
    dict: JSON,
}


def wrap(input_type) -> DType:
    """Convert a Python type annotation (or DType) into a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type is None:
        return NONE
    if input_type in _SIMPLE_FROM_PY:
        return _SIMPLE_FROM_PY[input_type]
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    if origin is typing.Union or origin is _pytypes.UnionType:  # X | None (PEP 604)
        non_none = [a for a in args if a is not type(None)]
        has_none = len(non_none) != len(args)
        if len(non_none) == 1:
            inner = wrap(non_none[0])
            return _Optional(inner) if has_none else inner
        return ANY
    if origin in (tuple,):
        if len(args) == 2 and args[1] is Ellipsis:
            return _List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (list,):
        return _List(wrap(args[0])) if args else _List(ANY)
    if origin in (dict,):
        return JSON
    if origin is typing.Callable or origin is getattr(__import__("collections.abc", fromlist=["Callable"]), "Callable", None):
        return Callable(Ellipsis, wrap(args[1]) if len(args) == 2 else ANY)
    if isinstance(input_type, type):
        # pw.Pointer[Schema] style subscripted generics fall here as plain class
        if issubclass(input_type, _etypes.Pointer):
            return POINTER
    try:
        if str(input_type).startswith("pathway"):
            return ANY
    except Exception:
        pass
    return ANY


def wrap_inner(t) -> DType:
    return t if isinstance(t, DType) else wrap(t)


def unoptionalize(t: DType) -> DType:
    return t.strip_optional()


def types_lca(a: DType, b: DType, *, raising: bool = False) -> DType:
    """Least common ancestor in the lattice (used by if_else/coalesce/concat)."""
    if a == b:
        return a
    if a is ERROR:
        return b
    if b is ERROR:
        return a
    if a is NONE:
        return _Optional(b)
    if b is NONE:
        return _Optional(a)
    a_opt = isinstance(a, _Optional)
    b_opt = isinstance(b, _Optional)
    if a_opt or b_opt:
        inner = types_lca(unoptionalize(a), unoptionalize(b), raising=raising)
        return _Optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, _Pointer) and (isinstance(b, _Pointer) or b is POINTER):
        return POINTER
    if isinstance(b, _Pointer) and a is POINTER:
        return POINTER
    if isinstance(a, _Tuple) and isinstance(b, _Tuple):
        if a.args is Ellipsis or b.args is Ellipsis or len(a.args) != len(b.args):
            return ANY_TUPLE
        return _Tuple(tuple(types_lca(x, y, raising=raising) for x, y in zip(a.args, b.args)))
    if isinstance(a, _Array) and isinstance(b, _Array):
        return _Array(a.n_dim if a.n_dim == b.n_dim else None, None)
    if raising:
        raise TypeError(f"cannot find common type for {a!r} and {b!r}")
    return ANY


def dtype_of_value(value: Any) -> DType:
    if value is None:
        return NONE
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT
    if isinstance(value, float):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, _etypes.Pointer):
        return POINTER
    if isinstance(value, _etypes.Json):
        return JSON
    if isinstance(value, _etypes.Error):
        return ERROR
    if isinstance(value, _etypes.PyObjectWrapper):
        return PY_OBJECT_WRAPPER
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, np.ndarray):
        return _Array(value.ndim, INT if np.issubdtype(value.dtype, np.integer) else FLOAT)
    if isinstance(value, tuple):
        return _Tuple(tuple(dtype_of_value(v) for v in value))
    return ANY


def tensor_to_numpy(value: torch.Tensor) -> np.ndarray:
    """A tensor as the host numpy array the JAX package stores for the same
    JAX array (``np.asarray``): same dtype, same values.  numpy has no
    bfloat16, so a bf16 tensor becomes an array of ``ml_dtypes.bfloat16``
    (JAX's own numpy bf16) with the same bits, never an upcast."""
    value = value.detach().cpu()
    if value.dtype != torch.bfloat16:
        return value.numpy()
    try:
        import ml_dtypes
    except ImportError as exc:
        raise TypeError(
            "a bfloat16 tensor enters a column as an ml_dtypes.bfloat16 numpy "
            "array, and the ml_dtypes package does not import"
        ) from exc
    return value.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


# Coercions applied when a value enters a column of a known dtype.
def coerce(value: Any, dtype: DType) -> Any:
    # hot-path exact (value type, dtype) exits — ingest calls this per cell
    t = type(value)
    if (
        (dtype is INT and t is int)
        or (dtype is FLOAT and t is float)
        or (dtype is STR and t is str)
        or (dtype is BOOL and t is bool)
        or (dtype is ANY and (t is int or t is float or t is str or t is bool))
    ):
        return value
    if value is None or isinstance(value, _etypes.Error):
        return value
    if isinstance(value, (np.ndarray, tuple)):
        value = _etypes.as_hashable(value)
        if isinstance(value, _etypes.HashableNDArray):
            return value
    elif isinstance(value, torch.Tensor):
        return _etypes.as_hashable(tensor_to_numpy(value))
    base = dtype.strip_optional()
    if base is FLOAT and isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        return float(value)
    if base is INT and isinstance(value, np.integer):
        return int(value)
    if base is JSON and not isinstance(value, _etypes.Json):
        return _etypes.Json(value)
    if isinstance(base, _List) and isinstance(value, list):
        return tuple(value)
    return value
