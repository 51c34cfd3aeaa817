"""Class-based row transformers with inter-row pointer references.

Parity target: ``python/pathway/internals/row_transformer.py`` (+ the
engine's ``complex_columns.rs``): ``@pw.transformer`` wraps a class of
inner ``pw.ClassArg`` tables; attributes computed for one row may follow
``Pointer`` values into any row of any inner table
(``self.transformer.other[ptr].attr``), recursively.

Engine mapping: the reference lowers each attribute into engine
``Computer``s with per-attribute dependency tracking.  Here a transformer
output table is one dataflow node that keeps its inputs' state, lazily
recomputes attributes with per-epoch memoization (each (table, row,
attribute) computed at most once per epoch, cycles detected), and emits
only the rows whose outputs changed — the same observable incremental
behavior with host-side bookkeeping kept off the device path (this
subsystem is row-wise Python by construction and never touches the MXU).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import KEY_MASK, Pointer, hash_values
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Lowerer, Table


# --- attribute markers ------------------------------------------------------


class _Marker:
    name: str = ""

    def __set_name__(self, owner, name):
        self.name = name


class _InputAttribute(_Marker):
    def __init__(self, **params):
        self.params = params


class _InputMethod(_Marker):
    def __init__(self, dtype=None, **params):
        self.dtype = dtype
        self.params = params


class _Computed(_Marker):
    def __init__(self, func: Callable, *, output: bool):
        self.func = func
        self.output = output


class _Method(_Marker):
    def __init__(self, func: Callable):
        self.func = func


def input_attribute(type: Any = None, **params) -> Any:
    """Declare a column taken from the input table (reference ``input_attribute``)."""
    return _InputAttribute(type=type, **params)


def input_method(type: Any = None, **params) -> Any:
    """Declare an input column holding callables (reference ``input_method``)."""
    return _InputMethod(dtype=type, **params)


def attribute(func: Callable) -> Any:
    """Computed attribute, not exported to the output table."""
    return _Computed(func, output=False)


def output_attribute(func: Callable) -> Any:
    """Computed attribute exported as an output column."""
    return _Computed(func, output=True)


def method(func: Callable) -> Any:
    """Exported method: the output column holds a callable per row."""
    return _Method(func)


# --- ClassArg ---------------------------------------------------------------


class ClassArg:
    """Base for transformer inner classes (reference ``ClassArg``).

    Subclassing collects the attribute markers; instances are row
    references created by the evaluator at compute time.
    """

    _input_attrs: dict[str, _InputAttribute]
    _input_methods: dict[str, _InputMethod]
    _computed: dict[str, _Computed]
    _methods: dict[str, _Method]
    _input_schema: type | None
    _output_schema: type | None

    def __init_subclass__(cls, /, input: type | None = None, output: type | None = None, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._input_schema = input
        cls._output_schema = output
        cls._input_attrs = {}
        cls._input_methods = {}
        cls._computed = {}
        cls._methods = {}
        for name, value in list(vars(cls).items()):
            if isinstance(value, _InputAttribute):
                cls._input_attrs[name] = value
            elif isinstance(value, _InputMethod):
                cls._input_methods[name] = value
            elif isinstance(value, _Computed):
                cls._computed[name] = value
            elif isinstance(value, _Method):
                cls._methods[name] = value


# --- evaluation -------------------------------------------------------------


class _CycleError(RuntimeError):
    pass


class RowReference:
    """``self`` inside attribute functions; follows pointers lazily."""

    __slots__ = ("_ev", "_table", "_key")

    def __init__(self, ev: "_Evaluator", table: str, key: int):
        self._ev = ev
        self._table = table
        self._key = key

    @property
    def id(self) -> Pointer:
        return Pointer(self._key)

    @property
    def transformer(self) -> "_TransformerRef":
        return _TransformerRef(self._ev)

    def pointer_from(self, *args, optional: bool = False) -> Pointer | None:
        if optional and any(a is None for a in args):
            return None
        return Pointer(hash_values(list(args)))

    def __getattr__(self, name: str):
        return self._ev.value(self._table, self._key, name)


class _TableRef:
    __slots__ = ("_ev", "_table")

    def __init__(self, ev: "_Evaluator", table: str):
        self._ev = ev
        self._table = table

    def __getitem__(self, ptr) -> RowReference:
        key = ptr.value if isinstance(ptr, Pointer) else int(ptr) & KEY_MASK
        return RowReference(self._ev, self._table, key)


class _TransformerRef:
    __slots__ = ("_ev",)

    def __init__(self, ev: "_Evaluator"):
        self._ev = ev

    def __getattr__(self, table: str) -> _TableRef:
        if table not in self._ev.classes:
            raise AttributeError(f"transformer has no table {table!r}")
        return _TableRef(self._ev, table)


class _Evaluator:
    """Per-epoch lazy attribute evaluation with memoization."""

    def __init__(self, classes: dict[str, type[ClassArg]], states: dict[str, dict[int, tuple]], input_names: dict[str, list[str]]):
        self.classes = classes
        self.states = states  # table -> key -> input row tuple
        self.input_names = input_names  # table -> input column order
        self.input_index = {
            t: {n: i for i, n in enumerate(names)}
            for t, names in input_names.items()
        }
        self.memo: dict[tuple[str, int, str], Any] = {}
        self.in_progress: set[tuple[str, int, str]] = set()

    def value(self, table: str, key: int, name: str):
        cls = self.classes[table]
        if name in cls._input_attrs or name in cls._input_methods:
            row = self.states[table].get(key)
            if row is None:
                raise KeyError(
                    f"row {Pointer(key)!r} is missing from transformer table {table!r}"
                )
            return row[self.input_index[table][name]]
        if name in cls._computed:
            slot = (table, key, name)
            if slot in self.memo:
                return self.memo[slot]
            if slot in self.in_progress:
                raise _CycleError(
                    f"cyclic attribute dependency at {table}.{name} for {Pointer(key)!r}"
                )
            self.in_progress.add(slot)
            try:
                result = cls._computed[name].func(RowReference(self, table, key))
            finally:
                self.in_progress.discard(slot)
            self.memo[slot] = result
            return result
        if name in cls._methods:
            func = cls._methods[name].func
            ref = RowReference(self, table, key)
            return lambda *args, **kwargs: func(ref, *args, **kwargs)
        # plain class helpers/constants (reference: aux objects pass through)
        value = getattr(cls, name)
        if callable(value) and not isinstance(value, (staticmethod, classmethod)):
            ref = RowReference(self, table, key)
            return lambda *args, **kwargs: value(ref, *args, **kwargs)
        return value


# --- dataflow node ----------------------------------------------------------


class _MethodCell:
    """Stable per-(row, method) callable: evaluates against the node's
    CURRENT input state at call time.  Identity-stable across epochs so
    method columns don't defeat the node's change diffing (a fresh lambda
    per epoch would retract+reinsert every row on every input change)."""

    __slots__ = ("node", "table", "key", "name")

    def __init__(self, node: "_TransformerNode", table: str, key: int, name: str):
        self.node = node
        self.table = table
        self.key = key
        self.name = name

    def __call__(self, *args, **kwargs):
        ev = self.node.evaluator()
        func = self.node.classes[self.table]._methods[self.name].func
        return func(RowReference(ev, self.table, self.key), *args, **kwargs)


class _TransformerNode(df.Node):
    """Recompute-and-diff: emits changed output rows each epoch."""

    name = "row_transformer"

    def __init__(self, scope, inputs, classes, input_names, table_name, out_names):
        super().__init__(scope, inputs)
        self.classes = classes
        self.input_names = input_names
        self.table_name = table_name
        cls = classes[table_name]
        self.attr_names = [n for n in out_names if n not in cls._methods]
        self.method_names = [n for n in out_names if n in cls._methods]
        self.out_names = out_names
        self.table_order = list(classes.keys())
        self._prev: dict[int, tuple] = {}
        self._cells: dict[tuple[int, str], _MethodCell] = {}

    def evaluator(self) -> _Evaluator:
        states = {
            t: self.inputs[i].state for i, t in enumerate(self.table_order)
        }
        return _Evaluator(self.classes, states, self.input_names)

    def _cell(self, key: int, name: str) -> _MethodCell:
        slot = (key, name)
        cell = self._cells.get(slot)
        if cell is None:
            cell = self._cells[slot] = _MethodCell(self, self.table_name, key, name)
        return cell

    def step(self, time):
        changed = False
        for port in range(len(self.inputs)):
            if self.take_pending(port):
                changed = True
        if not changed:
            return
        ev = self.evaluator()
        out: dict[int, tuple] = {}
        for key in ev.states[self.table_name]:
            out[key] = tuple(
                ev.value(self.table_name, key, n) for n in self.attr_names
            ) + tuple(self._cell(key, n) for n in self.method_names)
        deltas = []
        for key, row in out.items():
            prev = self._prev.get(key)
            if prev != row:
                if prev is not None:
                    deltas.append((key, prev, -1))
                deltas.append((key, row, 1))
        for key, prev in self._prev.items():
            if key not in out:
                deltas.append((key, prev, -1))
                for name in self.method_names:
                    self._cells.pop((key, name), None)
        self._prev = out
        self.send(deltas, time)


# --- the decorator ----------------------------------------------------------


class RowTransformer:
    def __init__(self, name: str, classes: dict[str, type[ClassArg]]):
        self.name = name
        self.classes = classes

    def __call__(self, *args: Table, **kwargs: Table):
        tables: dict[str, Table] = dict(zip(self.classes, args))
        tables.update(kwargs)
        missing = set(self.classes) - set(tables)
        if missing:
            raise ValueError(f"transformer {self.name}: missing tables {sorted(missing)}")
        input_names = {
            t: list(tables[t].column_names()) for t in self.classes
        }
        for tname, cls in self.classes.items():
            declared = set(cls._input_attrs) | set(cls._input_methods)
            absent = declared - set(input_names[tname])
            if absent:
                raise ValueError(
                    f"transformer {self.name}: table {tname!r} lacks input "
                    f"columns {sorted(absent)}"
                )
        result = _TransformerResult()
        for tname, cls in self.classes.items():
            out_names = [n for n, c in cls._computed.items() if c.output]
            out_names += list(cls._methods)
            setattr(
                result,
                tname,
                self._output_table(tname, tables, input_names, out_names),
            )
        return result

    def _output_table(self, table_name, tables, input_names, out_names):
        classes = self.classes
        cls = classes[table_name]
        cols = {}
        hints = {}
        if cls._output_schema is not None:
            hints = cls._output_schema.typehints()
        for n in out_names:
            dtype = dt.wrap(hints[n]) if n in hints else dt.ANY
            cols[n] = schema_mod.ColumnSchema(name=n, dtype=dtype)
        out_schema = schema_mod.schema_from_columns(cols, name=f"{self.name}_{table_name}")

        def build(lowerer: Lowerer) -> df.Node:
            nodes = [
                lowerer.node(tables[t]).require_state() for t in classes
            ]
            return _TransformerNode(
                lowerer.scope, nodes, classes, input_names, table_name, out_names
            )

        return Table(out_schema, build, universe=tables[table_name]._universe)


class _TransformerResult:
    pass


def transformer(cls: type) -> RowTransformer:
    """``@pw.transformer`` — collect inner ClassArg tables (reference
    ``decorators.py:58`` / ``row_transformer.py:38``)."""
    classes = {
        name: value
        for name, value in vars(cls).items()
        if isinstance(value, type) and issubclass(value, ClassArg)
    }
    if not classes:
        raise TypeError(
            f"@transformer class {cls.__name__} declares no ClassArg tables"
        )
    return RowTransformer(cls.__name__, classes)
