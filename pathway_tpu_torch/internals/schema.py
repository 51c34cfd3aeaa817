"""Class-based table schemas.

Parity target: ``python/pathway/internals/schema.py`` (955 LoC).
Supports the same user surface: subclassing ``pw.Schema`` with annotations,
``pw.column_definition`` for primary keys / defaults, ``schema_from_types``,
``schema_builder``, ``schema_from_dict``, ``schema_from_csv``, schema algebra
(``|``, ``update_types``, ``without``), and id-type plumbing.
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import typing
from typing import Any, Iterable, Mapping

from pathway_tpu_torch.internals import dtype as dt

_no_default = object()


@dataclasses.dataclass(frozen=True)
class ColumnDefinition:
    primary_key: bool = False
    default_value: Any = _no_default
    dtype: Any = None
    name: str | None = None
    append_only: bool | None = None
    description: str | None = None
    example: Any = _no_default

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _no_default


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _no_default,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
    description: str | None = None,
    example: Any = _no_default,
) -> ColumnDefinition:
    """Mirrors ``pw.column_definition`` (reference schema.py)."""
    return ColumnDefinition(
        primary_key=primary_key,
        default_value=default_value,
        dtype=dtype,
        name=name,
        append_only=append_only,
        description=description,
        example=example,
    )


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: dt.DType
    primary_key: bool = False
    default_value: Any = _no_default
    append_only: bool = False
    description: str | None = None

    @property
    def has_default_value(self) -> bool:
        return self.default_value is not _no_default


@dataclasses.dataclass(frozen=True)
class SchemaProperties:
    append_only: bool = False


def is_append_only(schema: "type[Schema]") -> bool:
    """Table-level append-onlyness: the schema-level flag, or every column
    declared append_only — the same fold the reference applies when it
    builds column properties (reference schema.py:251-259)."""
    if schema.__properties__.append_only:
        return True
    cols = schema.__columns__
    return bool(cols) and all(c.append_only for c in cols.values())


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnSchema]
    __properties__: SchemaProperties

    def __init__(cls, name, bases, namespace, append_only: bool | None = None, **kwargs):
        super().__init__(name, bases, namespace, **kwargs)
        columns: dict[str, ColumnSchema] = {}
        for base in bases:
            if hasattr(base, "__columns__"):
                columns.update(base.__columns__)
        hints = namespace.get("__annotations__", {})
        localns = vars(__import__("sys").modules.get(cls.__module__, None) or object())
        for attr, annotation in hints.items():
            if attr.startswith("__"):
                continue
            try:
                if isinstance(annotation, str):
                    annotation = eval(annotation, dict(localns), {})  # noqa: S307
            except Exception:
                annotation = Any
            definition = namespace.get(attr, None)
            if isinstance(definition, ColumnDefinition):
                dtype = dt.wrap(definition.dtype) if definition.dtype is not None else dt.wrap(annotation)
                columns[definition.name or attr] = ColumnSchema(
                    name=definition.name or attr,
                    dtype=dtype,
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    append_only=bool(definition.append_only),
                    description=definition.description,
                )
            else:
                columns[attr] = ColumnSchema(name=attr, dtype=dt.wrap(annotation))
        cls.__columns__ = columns
        cls.__properties__ = SchemaProperties(append_only=bool(append_only))

    # --- introspection (matches reference Schema classmethods) ---
    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> Mapping[str, ColumnSchema]:
        return dict(cls.__columns__)

    def keys(cls):
        return cls.__columns__.keys()

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls.__columns__.items()}

    def _dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pkeys or None

    def default_values(cls) -> dict[str, Any]:
        return {n: c.default_value for n, c in cls.__columns__.items() if c.has_default_value}

    def __or__(cls, other: "SchemaMetaclass"):
        cols = dict(cls.__columns__)
        for name, col in other.__columns__.items():
            if name in cols:
                raise ValueError(f"column {name!r} appears in both schemas")
            cols[name] = col
        return schema_from_columns(cols, name=f"{cls.__name__}|{other.__name__}")

    def __getitem__(cls, name: str) -> ColumnSchema:
        return cls.__columns__[name]

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<pw.Schema {cls.__name__}({cols})>"

    def update_types(cls, **kwargs):
        cols = dict(cls.__columns__)
        for name, new_type in kwargs.items():
            if name not in cols:
                raise ValueError(f"no column {name!r} in schema")
            cols[name] = dataclasses.replace(cols[name], dtype=dt.wrap(new_type))
        return schema_from_columns(cols, name=cls.__name__)

    def with_types(cls, **kwargs):
        return cls.update_types(**kwargs)

    def without(cls, *columns):
        names = {c if isinstance(c, str) else c.name for c in columns}
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_from_columns(cols, name=cls.__name__)

    def update_properties(cls, **kwargs):
        new = schema_from_columns(dict(cls.__columns__), name=cls.__name__)
        new.__properties__ = SchemaProperties(**kwargs)
        return new

    def universe_properties(cls):
        return cls.__properties__

    def with_id_type(cls, id_type):
        return cls

    def assert_matches_schema(
        cls,
        other: "SchemaMetaclass",
        *,
        allow_superset: bool = True,
        ignore_primary_keys: bool = True,
    ) -> None:
        for name, col in other.__columns__.items():
            if name not in cls.__columns__:
                raise AssertionError(f"column {name!r} missing")
            mine = cls.__columns__[name]
            if not mine.dtype.is_subclass_of(col.dtype) and col.dtype is not dt.ANY:
                raise AssertionError(
                    f"column {name!r}: {mine.dtype!r} does not match {col.dtype!r}"
                )
        if not allow_superset and set(cls.__columns__) != set(other.__columns__):
            raise AssertionError("schemas have different column sets")


class Schema(metaclass=SchemaMetaclass):
    r"""Base class for user-defined schemas (``class S(pw.Schema): x: int``).

    Example:

    >>> import pathway_tpu_torch as pw
    >>> class Person(pw.Schema):
    ...     name: str
    ...     age: int
    >>> print(Person.column_names())
    ['name', 'age']
    >>> t = pw.debug.table_from_markdown('name | age\nAda | 36', schema=Person)
    >>> pw.debug.compute_and_print(t, include_id=False)
    name | age
    Ada  | 36
    """

    def __init_subclass__(cls, **kwargs):
        # class keywords consumed by SchemaMetaclass.__init__ (e.g.
        # ``class S(pw.Schema, append_only=True)``) must not reach
        # object.__init_subclass__, which takes none
        kwargs.pop("append_only", None)
        super().__init_subclass__(**kwargs)


def schema_from_columns(columns: Mapping[str, ColumnSchema], name: str = "Schema") -> type[Schema]:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs) -> type[Schema]:
    """``pw.schema_from_types(x=int, y=str)``."""
    cols = {n: ColumnSchema(name=n, dtype=dt.wrap(t)) for n, t in kwargs.items()}
    return schema_from_columns(cols, name=_name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
) -> type[Schema]:
    """``pw.schema_builder`` — build a schema from column definitions."""
    cols = {}
    for attr, definition in columns.items():
        dtype = dt.wrap(definition.dtype) if definition.dtype is not None else dt.ANY
        cname = definition.name or attr
        cols[cname] = ColumnSchema(
            name=cname,
            dtype=dtype,
            primary_key=definition.primary_key,
            default_value=definition.default_value,
            append_only=bool(definition.append_only),
        )
    cls = schema_from_columns(cols, name=name)
    if properties is not None:
        cls.__properties__ = properties
    return cls


def schema_from_dict(
    columns: Mapping[str, Any],
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
) -> type[Schema]:
    """Build a schema from {name: type} or {name: {dtype, primary_key, default_value}}."""
    defs: dict[str, ColumnDefinition] = {}
    for cname, spec in columns.items():
        if isinstance(spec, dict):
            defs[cname] = column_definition(
                dtype=spec.get("dtype"),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _no_default),
            )
        else:
            defs[cname] = column_definition(dtype=spec)
    return schema_builder(defs, name=name, properties=properties)


def _infer_str_type(values: Iterable[str]) -> dt.DType:
    seen = dt.NONE
    for v in values:
        if v == "":
            continue
        for candidate, caster in ((dt.INT, int), (dt.FLOAT, float)):
            try:
                caster(v)
                this = candidate
                break
            except ValueError:
                this = None
        if this is None:
            if v.lower() in ("true", "false"):
                this = dt.BOOL
            else:
                this = dt.STR
        seen = this if seen is dt.NONE else dt.types_lca(seen, this)
    return dt.STR if seen is dt.NONE else seen


def schema_from_csv(
    path: str,
    *,
    name: str = "Schema",
    properties: SchemaProperties | None = None,
    delimiter: str = ",",
    quote: str = '"',
    comment_character: str | None = None,
    escape: str | None = None,
    double_quote_escapes: bool = True,
    num_parsed_rows: int | None = None,
) -> type[Schema]:
    """Infer a schema from a CSV file's header + sampled rows."""
    with open(path, newline="") as f:
        reader = _csv.reader(
            f,
            delimiter=delimiter,
            quotechar=quote,
            escapechar=escape,
            doublequote=double_quote_escapes,
        )
        rows = []
        header: list[str] | None = None
        for row in reader:
            if comment_character and row and row[0].startswith(comment_character):
                continue
            if header is None:
                header = row
                continue
            rows.append(row)
            if num_parsed_rows is not None and len(rows) >= num_parsed_rows:
                break
    if header is None:
        raise ValueError(f"empty CSV file: {path}")
    cols = {}
    for i, cname in enumerate(header):
        values = [r[i] for r in rows if i < len(r)]
        cols[cname] = ColumnSchema(name=cname, dtype=_infer_str_type(values))
    return schema_from_columns(cols, name=name)


def is_subschema(left: type[Schema], right: type[Schema]) -> bool:
    """Reference semantics (internals/schema.py:630): identical column sets
    with every left dtype a subtype of the right one."""
    if left.__columns__.keys() != right.__columns__.keys():
        return False
    for name, col in right.__columns__.items():
        if not left.__columns__[name].dtype.is_subclass_of(col.dtype):
            return False
    return True
