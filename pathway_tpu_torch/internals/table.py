"""The lazy Table API and its lowering to engine nodes.

Parity targets:
  * ``python/pathway/internals/table.py`` (2,675 LoC) — the
    ~45 public Table methods;
  * ``internals/joins.py`` (1,422), ``internals/groupbys.py`` (402);
  * ``internals/graph_runner/*`` — lowering of operators to engine calls.

Architecture: a ``Table`` is a schema plus a *recipe* — a function from a
``Lowerer`` to an engine ``Node``.  Calling Table methods composes recipes;
``pw.run``/debug helpers instantiate a fresh engine ``Scope`` and lower the
sinks' dependency cones.  Cross-table references inside ``select`` (same
universe) and ``other.ix(expr)`` lookups are both lowered onto the engine's
``IxNode`` so that a change in the *referenced* table correctly retracts and
re-emits dependent rows — the property the reference gets from differential's
join-based column paths.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Mapping, Sequence

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.engine.types import (
    ERROR,
    Error,
    Pointer,
    hash_values,
)
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)
from pathway_tpu_torch.internals.expression_evaluator import Binder, compile_expr
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.thisclass import ThisPlaceholder, ThisSlice, this

_object_id = id  # `id` is a common keyword parameter below; keep the builtin reachable

# ---------------------------------------------------------------------------
# Universe tracking (universe.py + universe_solver.py analog)
# ---------------------------------------------------------------------------


class Universe:
    _counter = itertools.count()

    def __init__(self, parent: "Universe | None" = None):
        self.id = next(Universe._counter)
        self._parent = parent
        self._equal_root: "Universe" = self
        self._subset_of: set[int] = set()

    def root(self) -> "Universe":
        u = self
        while u._equal_root is not u:
            u = u._equal_root
        if self._equal_root is not u:
            self._equal_root = u
        return u

    def unify(self, other: "Universe") -> None:
        self.root()._equal_root = other.root()

    def is_equal(self, other: "Universe") -> bool:
        return self.root() is other.root()

    def is_subset_of(self, other: "Universe") -> bool:
        if self.is_equal(other):
            return True
        u: Universe | None = self
        seen = set()
        stack = [self.root()]
        while stack:
            cur = stack.pop()
            if cur.id in seen:
                continue
            seen.add(cur.id)
            if cur.is_equal(other):
                return True
            if cur._parent is not None:
                stack.append(cur._parent.root())
            for sid in cur._subset_of:
                stack.append(_universe_registry[sid].root())
        return False

    def promise_subset_of(self, other: "Universe") -> None:
        self._subset_of.add(other.root().id)
        _universe_registry[other.root().id] = other.root()


_universe_registry: dict[int, Universe] = {}


# ---------------------------------------------------------------------------
# Lowerer (GraphRunner analog)
# ---------------------------------------------------------------------------


class Lowerer:
    def __init__(self, scope: df.Scope):
        self.scope = scope
        self.memo: dict[int, df.Node] = {}
        self.pollers: list[Any] = []  # objects with .poll() -> bool(finished)
        self.cleanups: list[Callable[[], None]] = []
        self.persistence_storage: Any = None  # engine.persistence.PersistentStorage
        self._source_counter = 0

    def node(self, table: "Table") -> df.Node:
        key = id(table)
        if key not in self.memo:
            try:
                node = table._build(self)
            except Exception as exc:
                # recipe errors (bad column refs, type mismatches) fire at
                # lowering, far from the user's call — cite their line
                if table._trace_frame is not None:
                    from pathway_tpu_torch.internals.trace import add_trace_note

                    add_trace_note(exc, table._trace_frame)
                raise
            if getattr(node, "user_frame", None) is None:
                node.user_frame = table._trace_frame
            self.memo[key] = node
        return self.memo[key]


# ---------------------------------------------------------------------------
# Special expressions that need the Table layer
# ---------------------------------------------------------------------------


class IxColumnExpression(ColumnExpression):
    """``other.ix(keys).col`` / implicit same-universe foreign reference."""

    __slots__ = ("_data_table", "_key_expr", "_name", "_optional", "_by_id")

    def __init__(self, data_table, key_expr, name, optional=False, by_id=False):
        self._data_table = data_table
        self._key_expr = expr_mod._wrap(key_expr)
        self._name = name
        self._optional = optional
        self._by_id = by_id  # True: implicit same-universe ref (key = row id)

    def _sub_expressions(self):
        return (self._key_expr,)

    def _substitute(self, mapping):
        return IxColumnExpression(
            self._data_table,
            self._key_expr._substitute(mapping),
            self._name,
            self._optional,
            self._by_id,
        )

    def _infer_dtype(self, resolver):
        if self._name == "id":
            base = dt.POINTER
        else:
            col = self._data_table.schema.__columns__.get(self._name)
            base = col.dtype if col else dt.ANY
        return dt.Optional(base) if self._optional else base


class IxRowView:
    """Result of ``table.ix(expr)`` — attribute access yields column exprs."""

    def __init__(self, data_table, key_expr, optional=False):
        self._data_table = data_table
        self._key_expr = key_expr
        self._optional = optional

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return IxColumnExpression(self._data_table, self._key_expr, name, self._optional)

    def __getitem__(self, name):
        if isinstance(name, ColumnReference):
            name = name.name
        return IxColumnExpression(self._data_table, self._key_expr, name, self._optional)

    @property
    def id(self):
        return IxColumnExpression(self._data_table, self._key_expr, "id", self._optional)


class IxAppliedPlaceholder:
    """``pw.this.ix(expr)`` — resolved when bound to a table in select."""

    def __init__(self, base, key_expr, optional=False):
        self._base = base
        self._key_expr = key_expr
        self._optional = optional

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeferredIxColumnExpression(self._key_expr, name, self._optional, ref_args=None)


class IxRefAppliedPlaceholder:
    def __init__(self, base, args, optional=False, instance=None):
        self._base = base
        self._args = args
        self._optional = optional
        self._instance = instance

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeferredIxColumnExpression(
            None, name, self._optional, ref_args=(self._args, self._instance)
        )


class DeferredIxColumnExpression(ColumnExpression):
    """ix on pw.this: the data table is the table select() is called on."""

    __slots__ = ("_key_expr", "_name", "_optional", "_ref_args")

    def __init__(self, key_expr, name, optional, ref_args):
        self._key_expr = expr_mod._wrap(key_expr) if key_expr is not None else None
        self._name = name
        self._optional = optional
        self._ref_args = ref_args

    def _substitute(self, mapping):
        # once we know the concrete table (mapping from `this`), become real
        target = mapping.get(id(this))
        key_expr = (
            self._key_expr._substitute(mapping) if self._key_expr is not None else None
        )
        if target is not None:
            if self._ref_args is not None:
                args, instance = self._ref_args
                args = [expr_mod._wrap(a)._substitute(mapping) for a in args]
                key_expr = expr_mod.PointerExpression(
                    target, *args, optional=self._optional, instance=instance
                )
            return IxColumnExpression(target, key_expr, self._name, self._optional)
        new = DeferredIxColumnExpression(key_expr, self._name, self._optional, self._ref_args)
        return new


# ---------------------------------------------------------------------------
# Binders
# ---------------------------------------------------------------------------


class RowBinder(Binder):
    """Resolves references for expressions evaluated over one table's rows.

    Layout of the evaluation row: the table's columns first, then appended
    regions for each external fetch (same-universe foreign tables and
    ``ix`` lookups), in registration order.
    """

    def __init__(self, lowerer: Lowerer, table: "Table"):
        self.lowerer = lowerer
        self.table = table
        self.col_index = {n: i for i, n in enumerate(table.column_names())}
        self.width = len(self.col_index)
        # fetch registry: fetch_key -> (slot, data_table, key_fn, optional);
        # key_fn None means by-id fetch.  Key expressions are compiled BEFORE
        # the slot is allocated so nested fetches (an ix whose key comes from
        # another fetched column) land earlier in the chain than their users.
        self.fetches: dict[Any, tuple[int, "Table", Any, bool]] = {}
        self.fetch_order: list[Any] = []

    def _fetch_slot(self, data_table, key_expr, optional, by_id) -> tuple[int, "Table"]:
        fk = (id(data_table), repr(key_expr) if key_expr is not None else "@id", optional)
        if fk not in self.fetches:
            key_fn = compile_expr(key_expr, self) if key_expr is not None else None
            if fk not in self.fetches:  # (key compile may have nested same fk)
                slot = self.width
                self.width += len(data_table.column_names()) + 1  # +1 for fetched id
                self.fetches[fk] = (slot, data_table, key_fn, optional)
                self.fetch_order.append(fk)
        return self.fetches[fk][0], data_table

    def resolve(self, ref: ColumnReference):
        tbl = ref.table
        name = ref.name
        if isinstance(tbl, ThisPlaceholder) or tbl is self.table:
            if name == "id":
                return lambda key, row: Pointer(key)
            if name not in self.col_index:
                raise KeyError(
                    f"no column {name!r} in table (columns: {list(self.col_index)})"
                )
            idx = self.col_index[name]
            return lambda key, row: row[idx]
        if isinstance(tbl, Table):
            # same-universe foreign reference — implicit ix by id
            if not tbl._universe.is_equal(self.table._universe) and not self.table._universe.is_subset_of(tbl._universe):
                raise ValueError(
                    f"column {name!r} of a table with a different universe used in "
                    "select; use .ix(...), a join, or promise_universes_are_equal"
                )
            slot, data_table = self._fetch_slot(tbl, None, False, True)
            if name == "id":
                return lambda key, row: row[slot]
            didx = slot + 1 + data_table.column_names().index(name)
            return lambda key, row: row[didx]
        raise ValueError(f"cannot resolve reference {ref!r}")

    def resolve_ix(self, e: IxColumnExpression):
        slot, data_table = self._fetch_slot(
            e._data_table, e._key_expr, e._optional, e._by_id
        )
        if e._name == "id":
            return lambda key, row: row[slot]
        names = data_table.column_names()
        if e._name not in names:
            raise KeyError(f"no column {e._name!r} in ix'd table")
        didx = slot + 1 + names.index(e._name)
        return lambda key, row: row[didx]

    def resolve_dtype(self, ref: ColumnReference) -> dt.DType:
        tbl = ref.table
        if isinstance(tbl, ThisPlaceholder) or tbl is self.table:
            if ref.name == "id":
                return dt.POINTER
            col = self.table.schema.__columns__.get(ref.name)
            return col.dtype if col else dt.ANY
        if isinstance(tbl, Table):
            col = tbl.schema.__columns__.get(ref.name)
            return col.dtype if col else dt.ANY
        return dt.ANY


# patch expression_evaluator's recursion to understand IxColumnExpression
import pathway_tpu_torch.internals.expression_evaluator as _ev  # noqa: E402

_ev_compile_orig = _ev.compile_expr


def _patched_compile(e, binder):
    if isinstance(e, IxColumnExpression) and isinstance(binder, RowBinder):
        return binder.resolve_ix(e)
    return _ev_compile_orig(e, binder)


_ev.compile_expr = _patched_compile
compile_expr = _patched_compile  # use everywhere below


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _desugar(e: Any, table: "Table", extra_map: dict[int, Any] | None = None):
    e = expr_mod._wrap(e)
    mapping = {id(this): table}
    if extra_map:
        mapping.update(extra_map)
    return e._substitute(mapping)


def _infer_dtype(e: ColumnExpression, binder: RowBinder) -> dt.DType:
    try:
        return e._infer_dtype(binder.resolve_dtype)
    except Exception:
        return dt.ANY


def _name_of_expr(e: Any) -> str:
    if isinstance(e, ColumnReference):
        return e.name
    if isinstance(e, IxColumnExpression):
        return e._name
    if isinstance(e, DeferredIxColumnExpression):
        return e._name
    raise ValueError(
        f"cannot infer a column name for expression {e!r}; pass it as name=expression"
    )


def _expand_args(args: Sequence[Any], table: "Table") -> dict[str, Any]:
    """Expand positional select/reduce args (column refs + this-slices)."""
    out: dict[str, Any] = {}
    for a in args:
        if isinstance(a, ThisSlice):
            for n in a._column_names(table):
                out[n] = ColumnReference(this, n)
        elif isinstance(a, TableSlice):
            for n in a.column_names():
                out[n] = ColumnReference(a._table, n)
        elif isinstance(a, Table):
            for n in a.column_names():
                out[n] = ColumnReference(a, n)
        else:
            out[_name_of_expr(a)] = a
    return out


class _IxMerge:
    """merge(row, data_row_with_key) appending (id, *data_columns)."""

    def __init__(self, n_cols):
        self.n_cols = n_cols

    def __call__(self, row, data_row):
        if data_row is None:
            return row + (None,) * (self.n_cols + 1)
        return row + data_row


# IxNode passes raw data rows; wrap data node so fetched region includes id.
class _DataWithIdNode(df.Node):
    name = "with_id_col"
    preserves_append_only = True

    def __init__(self, scope, inp):
        super().__init__(scope, [inp])

    def step(self, time):
        out = []
        for key, row, diff in self.take_pending():
            out.append((key, (Pointer(key),) + row, diff))
        if self.keep_state:
            self._update_state(out)
        self.send(out, time)


def _trim_if_needed(lowerer, node: df.Node, binder: "RowBinder", n_cols: int) -> df.Node:
    """Strip fetch-appended columns so output rows match the declared schema."""
    if not binder.fetch_order:
        return node
    return df.ExprNode(lowerer.scope, node, lambda key, row: row[:n_cols])


def _fetch_chain(lowerer, base_node, binder: RowBinder) -> df.Node:
    node = base_node
    for fk in binder.fetch_order:
        slot, data_table, kf, optional = binder.fetches[fk]
        raw_data = lowerer.node(data_table)
        data_node = _DataWithIdNode(lowerer.scope, raw_data).require_state()
        if kf is None:
            key_fn = lambda key, row: key  # noqa: E731
        else:

            def key_fn(key, row, _kf=kf):
                v = _kf(key, row)
                if isinstance(v, Pointer):
                    return v.value
                return v

        node = df.IxNode(
            lowerer.scope,
            node,
            data_node,
            key_fn,
            _IxMerge(len(data_table.column_names())),
            optional=optional,
            strict=not optional,
        )
    return node


# ---------------------------------------------------------------------------
# Joinable base + JoinMode
# ---------------------------------------------------------------------------


import enum


class JoinMode(enum.Enum):
    INNER = 0
    LEFT = 1
    RIGHT = 2
    OUTER = 3


class Joinable:
    def join(self, other, *on, id=None, how=JoinMode.INNER, left_instance=None, right_instance=None):
        """Join with ``other`` on equality conditions; ``how`` picks the join mode.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... owner | pet
        ... Alice | dog
        ... Bob   | cat
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... pet | sound
        ... dog | woof
        ... cat | meow
        ... ''')
        >>> j = t1.join(t2, t1.pet == t2.pet).select(t1.owner, t2.sound)
        >>> pw.debug.compute_and_print(j, include_id=False)
        owner | sound
        Alice | woof
        Bob   | meow
        """
        return JoinResult(self, other, on, mode=how, id=id)

    def join_inner(self, other, *on, id=None, **kw):
        return JoinResult(self, other, on, mode=JoinMode.INNER, id=id)

    def join_left(self, other, *on, id=None, **kw):
        """Left outer join: unmatched left rows survive with ``None`` fills.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.debug.table_from_markdown('''
        ... owner | pet
        ... Alice | dog
        ... Eve   | axolotl
        ... ''')
        >>> t2 = pw.debug.table_from_markdown('''
        ... pet | sound
        ... dog | woof
        ... ''')
        >>> j = t1.join_left(t2, t1.pet == t2.pet).select(t1.owner, t2.sound)
        >>> pw.debug.compute_and_print(j, include_id=False)
        owner | sound
        Alice | woof
        Eve   | None
        """
        return JoinResult(self, other, on, mode=JoinMode.LEFT, id=id)

    def join_right(self, other, *on, id=None, **kw):
        return JoinResult(self, other, on, mode=JoinMode.RIGHT, id=id)

    def join_outer(self, other, *on, id=None, **kw):
        return JoinResult(self, other, on, mode=JoinMode.OUTER, id=id)


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


class Table(Joinable):
    def __init__(
        self,
        schema: type[schema_mod.Schema],
        build: Callable[[Lowerer], df.Node],
        universe: Universe | None = None,
    ):
        self._schema = schema
        self._build_fn = build
        self._universe = universe if universe is not None else Universe()
        _universe_registry[self._universe.id] = self._universe
        # where the user created this table: replayed onto run-time engine
        # errors from operators lowered out of it (reference trace.py)
        from pathway_tpu_torch.internals.trace import user_frame_from_stack

        self._trace_frame = user_frame_from_stack()
        G.new_table(self)

    # -- introspection --
    @property
    def schema(self) -> type[schema_mod.Schema]:
        return self._schema

    def column_names(self) -> list[str]:
        return list(self._schema.__columns__.keys())

    def keys(self):
        return self._schema.__columns__.keys()

    def typehints(self) -> dict[str, Any]:
        return self._schema.typehints()

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_") or name in ("schema",):
            raise AttributeError(name)
        if name in self._schema.__columns__:
            return ColumnReference(self, name)
        raise AttributeError(
            f"Table has no column {name!r} (columns: {self.column_names()})"
        )

    def __getitem__(self, arg):
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            if arg not in self._schema.__columns__:
                raise KeyError(arg)
            return ColumnReference(self, arg)
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg.name)
        if isinstance(arg, (list, tuple)):
            return TableSlice(self, [c if isinstance(c, str) else c.name for c in arg])
        raise TypeError(f"cannot index Table with {type(arg)}")

    def __iter__(self):
        raise TypeError("Table is not iterable; use pw.debug helpers")

    def __repr__(self):
        cols = ", ".join(
            f"{n}: {c.dtype!r}" for n, c in self._schema.__columns__.items()
        )
        return f"<pw.Table ({cols})>"

    def live(self):
        """Run this table's cone on a background thread and return a
        LiveTable (inspectable while streaming, composable into further
        graph operations).  Experimental — match:
        ``python/pathway/internals/table.py:2565``.
        """
        import warnings

        from pathway_tpu_torch.internals.interactive import LiveTable

        warnings.warn("live tables are an experimental feature", stacklevel=2)
        return LiveTable._create(self)

    @property
    def slice(self) -> "TableSlice":
        return TableSlice(self, self.column_names())

    @property
    def C(self) -> "TableSlice":
        return TableSlice(self, self.column_names())

    def _build(self, lowerer: Lowerer) -> df.Node:
        return self._build_fn(lowerer)

    # -- core ops --
    def select(self, *args, **kwargs) -> "Table":
        """Produce a new table with the given columns (same rows/keys).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> pw.debug.compute_and_print(t.select(pw.this.owner, older=pw.this.age + 1), include_id=False)
        owner | older
        Alice | 6
        Bob   | 4
        Carol | 9
        """
        exprs = _expand_args(args, self)
        exprs.update(kwargs)
        return self._select_impl(exprs, universe=self._universe)

    def _select_impl(self, exprs: Mapping[str, Any], universe: Universe) -> "Table":
        desugared = {n: _desugar(e, self) for n, e in exprs.items()}

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            # top-level async UDF columns run through AsyncValuesNode so all
            # rows of an epoch are awaited concurrently (§3.3 semantics);
            # other columns compile to plain row functions
            fns: dict[str, Any] = {}
            async_slot: dict[str, int] = {}
            coro_fns: list = []
            for n, e in desugared.items():
                if isinstance(e, expr_mod.AsyncApplyExpression):
                    arg_fns = [compile_expr(a, binder) for a in e._args]
                    kw_fns = {
                        k: compile_expr(v, binder) for k, v in e._kwargs.items()
                    }
                    fun = e._fun

                    def make_coro(fun=fun, arg_fns=arg_fns, kw_fns=kw_fns):
                        def coro(key, row):
                            return fun(
                                *[f(key, row) for f in arg_fns],
                                **{k: f(key, row) for k, f in kw_fns.items()},
                            )

                        return coro

                    async_slot[n] = len(coro_fns)
                    coro_fns.append(make_coro())
                    fns[n] = None
                else:
                    fns[n] = compile_expr(e, binder)
            node_in = _fetch_chain(lowerer, base, binder)
            async_base = binder.width
            if coro_fns:
                node_in = df.AsyncValuesNode(lowerer.scope, node_in, coro_fns)
            out_dtypes = [new_schema.__columns__[n].dtype for n in fns]

            def fn(key, row, _items=list(fns.items()), _dts=out_dtypes):
                out = []
                for (n, f), d in zip(_items, _dts):
                    if f is None:
                        v = row[async_base + async_slot[n]]
                    else:
                        v = f(key, row)
                    out.append(dt.coerce(v, d))
                return tuple(out)

            node_out = df.ExprNode(lowerer.scope, node_in, fn)
            if not coro_fns and not binder.fetches:
                # columnar fast path: all output expressions must vectorize
                from pathway_tpu_torch.internals import vector_compiler as vc

                vec_fns, needed = [], set()
                for e in desugared.values():
                    # bare column refs skip materialize/rebuild entirely:
                    # the native rebuild copies them from the input row
                    pt = vc.passthrough_index(e, binder)
                    if pt is not None:
                        vec_fns.append(pt)
                        continue
                    compiled = vc.try_compile_vec(e, binder)
                    if compiled is None:
                        vec_fns = None
                        break
                    f_vec, used = compiled
                    vec_fns.append(f_vec)
                    needed |= used
                if vec_fns is not None:
                    node_out.vec_select = (needed, vec_fns, out_dtypes)
            return node_out

        # schema inference
        tmp_binder = RowBinder(Lowerer(df.Scope()), self)
        cols = {}
        for n, e in desugared.items():
            cols[n] = schema_mod.ColumnSchema(name=n, dtype=_infer_dtype(e, tmp_binder))
        new_schema = schema_mod.schema_from_columns(cols)
        return Table(new_schema, build, universe=universe)

    def with_columns(self, *args, **kwargs) -> "Table":
        exprs = {n: ColumnReference(this, n) for n in self.column_names()}
        exprs.update(_expand_args(args, self))
        exprs.update(kwargs)
        return self._select_impl(exprs, universe=self._universe)

    def without(self, *columns) -> "Table":
        """Drop the given columns.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> pw.debug.compute_and_print(t.without(pw.this.age), include_id=False)
        owner | pet
        Alice | dog
        Bob   | cat
        Carol | dog
        """
        names = {c if isinstance(c, str) else c.name for c in columns}
        exprs = {
            n: ColumnReference(this, n) for n in self.column_names() if n not in names
        }
        return self._select_impl(exprs, universe=self._universe)

    def rename(self, names_mapping: dict | None = None, **kwargs) -> "Table":
        """Rename columns (``new=old`` keyword form or a ``{old: new}`` mapping).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> pw.debug.compute_and_print(t.rename(years=pw.this.age).select(pw.this.owner, pw.this.years), include_id=False)
        owner | years
        Alice | 5
        Bob   | 3
        Carol | 8
        """
        if names_mapping:
            return self.rename_by_dict(names_mapping)
        return self.rename_columns(**kwargs)

    def rename_columns(self, **kwargs) -> "Table":
        # new_name=old_ref
        old_of_new = {
            new: (old.name if isinstance(old, ColumnReference) else old)
            for new, old in kwargs.items()
        }
        renamed_olds = set(old_of_new.values())
        exprs: dict[str, Any] = {}
        for n in self.column_names():
            if n in renamed_olds:
                continue
            exprs[n] = ColumnReference(this, n)
        for new, old in old_of_new.items():
            exprs[new] = ColumnReference(this, old)
        return self._select_impl(exprs, universe=self._universe)

    def rename_by_dict(self, names_mapping: Mapping) -> "Table":
        mapping = {
            (k.name if isinstance(k, ColumnReference) else k): v
            for k, v in names_mapping.items()
        }
        exprs: dict[str, Any] = {}
        for n in self.column_names():
            exprs[mapping.get(n, n)] = ColumnReference(this, n)
        return self._select_impl(exprs, universe=self._universe)

    def with_prefix(self, prefix: str) -> "Table":
        return self.rename_by_dict({n: prefix + n for n in self.column_names()})

    def with_suffix(self, suffix: str) -> "Table":
        return self.rename_by_dict({n: n + suffix for n in self.column_names()})

    def filter(self, filter_expression) -> "Table":
        """Keep only the rows satisfying the predicate.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> pw.debug.compute_and_print(t.filter(pw.this.pet == 'dog'), include_id=False)
        owner | pet | age
        Alice | dog | 5
        Carol | dog | 8
        """
        e = _desugar(filter_expression, self)

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            pred = compile_expr(e, binder)
            node_in = _fetch_chain(lowerer, base, binder)
            n_cols = len(self.column_names())

            from pathway_tpu_torch.internals import vector_compiler as vc

            vec = None if binder.fetches else vc.try_compile_vec(e, binder)

            class _PredFilter(df.Node):
                name = "filter"
                preserves_append_only = True

                def _try_columnar(self_inner, deltas):
                    f_vec, needed = vec
                    cols = vc.materialize_delta_columns(deltas, needed)
                    if cols is None:
                        vc.note_bail("filter", "dirty-column")
                        return None
                    try:
                        mask = f_vec(cols, len(deltas))
                    except vc.VecBail:
                        vc.note_bail("filter", "value-guard")
                        return None
                    if mask.dtype.kind != "b":
                        vc.note_bail("filter", "result-dtype")
                        return None
                    return vc.filter_deltas(deltas, mask, n_cols)

                def step(self_inner, time):
                    deltas = self_inner.take_pending()
                    out = None
                    if (
                        vec is not None
                        and vc.ENABLED
                        and len(deltas) >= vc.VEC_THRESHOLD
                    ):
                        out = self_inner._try_columnar(deltas)
                    if deltas and vec is not None:
                        if out is None:
                            self_inner.row_batches += 1
                        else:
                            self_inner.vec_batches += 1
                    if out is None:
                        out = []
                        for key, row, diff in deltas:
                            res = pred(key, row)
                            if isinstance(res, Error):
                                continue
                            if res:
                                out.append((key, row[:n_cols], diff))
                    if isinstance(deltas, df.CleanDeltas):
                        out = df.CleanDeltas(out)  # key-subset of clean
                    if self_inner.keep_state:
                        self_inner._update_state(out)
                    self_inner.send(out, time)

            return _PredFilter(lowerer.scope, [node_in])

        return Table(self._schema, build, universe=Universe(parent=self._universe))

    def split(self, split_expression):
        positive = self.filter(split_expression)
        negative = self.filter(~expr_mod._wrap(split_expression))
        return positive, negative

    def copy(self) -> "Table":
        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)

            class _Copy(df.Node):
                name = "copy"
                preserves_append_only = True

            return _Copy(lowerer.scope, [base])

        return Table(self._schema, build, universe=self._universe)

    def flatten(self, to_flatten: ColumnReference, *, origin_id: str | None = None) -> "Table":
        """One output row per element of an iterable column.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pets
        ... Alice | dog,cat
        ... Bob   | fish
        ... ''')
        >>> s = t.select(pw.this.owner, pet=pw.this.pets.str.split(','))
        >>> pw.debug.compute_and_print(s.flatten(pw.this.pet), include_id=False)
        owner | pet
        Alice | cat
        Alice | dog
        Bob   | fish
        """
        col = to_flatten.name
        col_idx = self.column_names().index(col)
        names = self.column_names()

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)

            def fn(key, row, _i=col_idx):
                seq = row[_i]
                if seq is None:
                    return
                if isinstance(seq, str):
                    items = list(seq)
                else:
                    try:
                        items = list(seq)
                    except TypeError:
                        items = [seq]
                for pos, item in enumerate(items):
                    new_key = hash_values([Pointer(key), pos])
                    new_row = row[:_i] + (item,) + row[_i + 1 :]
                    if origin_id is not None:
                        new_row = new_row + (Pointer(key),)
                    yield (new_key, new_row)

            # new keys are hash(origin key, position): pairwise distinct
            node = df.FlattenNode(lowerer.scope, base, fn, key_fresh=True)
            node.vec_flatten = (col_idx, origin_id is not None)
            return node

        cols = dict(self._schema.__columns__)
        inner_t = cols[col].dtype.strip_optional()
        if isinstance(inner_t, dt._List):
            new_t = inner_t.wrapped
        elif isinstance(inner_t, dt._Tuple) and inner_t.args is not Ellipsis:
            new_t = dt.types_lca(*inner_t.args) if len(inner_t.args) > 1 else inner_t.args[0]
        elif inner_t is dt.STR:
            new_t = dt.STR
        else:
            new_t = dt.ANY
        cols[col] = schema_mod.ColumnSchema(name=col, dtype=new_t)
        if origin_id is not None:
            cols[origin_id] = schema_mod.ColumnSchema(name=origin_id, dtype=dt.POINTER)
        return Table(schema_mod.schema_from_columns(cols), build, universe=Universe())

    # -- id manipulation --
    def pointer_from(self, *args, optional: bool = False, instance=None):
        return expr_mod.PointerExpression(self, *args, optional=optional, instance=instance)

    def with_id_from(self, *args, instance=None) -> "Table":
        """Re-key rows from the given expressions (primary-key change).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> r = t.with_id_from(pw.this.owner)
        >>> pw.debug.compute_and_print(r.select(pw.this.owner, pw.this.age), include_id=False)
        owner | age
        Alice | 5
        Bob   | 3
        Carol | 8
        """
        exprs = [_desugar(expr_mod._wrap(a), self) for a in args]
        if instance is not None:
            exprs.append(_desugar(expr_mod._wrap(instance), self))

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            fns = [compile_expr(e, binder) for e in exprs]
            node_in = _fetch_chain(lowerer, base, binder)

            def key_fn(key, row):
                return hash_values([f(key, row) for f in fns])

            node = df.ReindexNode(lowerer.scope, node_in, key_fn)
            return _trim_if_needed(lowerer, node, binder, len(self.column_names()))

        return Table(self._schema, build, universe=Universe())

    def with_id(self, new_index: ColumnReference) -> "Table":
        e = _desugar(new_index, self)

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            f = compile_expr(e, binder)
            node_in = _fetch_chain(lowerer, base, binder)

            def key_fn(key, row):
                v = f(key, row)
                return v.value if isinstance(v, Pointer) else v

            node = df.ReindexNode(lowerer.scope, node_in, key_fn)
            return _trim_if_needed(lowerer, node, binder, len(self.column_names()))

        return Table(self._schema, build, universe=Universe())

    # -- set ops --
    def _rekey_salted(self, salt: int) -> "Table":
        """Injective deterministic rekey: new id = hash(old id, salt).
        Internal — backs the vectorized sliding-window branches (each
        branch needs distinct, replay-stable keys)."""

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            return df.SaltRekeyNode(lowerer.scope, base, salt)

        return Table(self.schema, build, universe=Universe())

    def concat(self, *others: "Table") -> "Table":
        r"""Union of rows of same-schema tables (keys must be disjoint).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('v\n1\n2')
        >>> b = pw.debug.table_from_markdown('v\n3')
        >>> pw.debug.compute_and_print(a.concat(b), include_id=False)
        v
        2
        3
        """
        tables = [self, *others]
        names = self.column_names()
        for t in others:
            if t.column_names() != names:
                raise ValueError("concat: column sets differ")

        def build(lowerer: Lowerer) -> df.Node:
            nodes = [lowerer.node(t) for t in tables]
            return df.ConcatNode(lowerer.scope, nodes)

        cols = {}
        for n in names:
            merged = self._schema.__columns__[n].dtype
            for t in others:
                merged = dt.types_lca(merged, t._schema.__columns__[n].dtype)
            cols[n] = schema_mod.ColumnSchema(name=n, dtype=merged)
        return Table(schema_mod.schema_from_columns(cols), build, universe=Universe())

    def concat_reindex(self, *others: "Table") -> "Table":
        tables = [self, *others]
        reindexed = [
            t.with_id_from(ColumnReference(this, "id"), instance=i)
            if False
            else t._reindex_tagged(i)
            for i, t in enumerate(tables)
        ]
        return reindexed[0].concat(*reindexed[1:])

    def _reindex_tagged(self, tag: int) -> "Table":
        # same injective hash(Pointer(id), tag) recipe as the sliding
        # branches: the salted-rekey node needs no duplicate-detection
        # state and runs the native C pass
        return self._rekey_salted(tag)

    def update_rows(self, other: "Table") -> "Table":
        r"""Upsert: rows of ``other`` replace/extend rows with the same key.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> old = pw.debug.table_from_markdown('k | v\na | 1\nb | 2', id_from=['k'])
        >>> new = pw.debug.table_from_markdown('k | v\nb | 9\nc | 3', id_from=['k'])
        >>> pw.debug.compute_and_print(old.update_rows(new), include_id=False)
        k | v
        a | 1
        b | 9
        c | 3
        """
        if other.column_names() != self.column_names():
            raise ValueError("update_rows: column sets must match")

        def build(lowerer: Lowerer) -> df.Node:
            return df.UpdateRowsNode(
                lowerer.scope, lowerer.node(self), lowerer.node(other)
            )

        cols = {}
        for n in self.column_names():
            cols[n] = schema_mod.ColumnSchema(
                name=n,
                dtype=dt.types_lca(
                    self._schema.__columns__[n].dtype, other._schema.__columns__[n].dtype
                ),
            )
        return Table(schema_mod.schema_from_columns(cols), build, universe=Universe())

    def update_cells(self, other: "Table") -> "Table":
        r"""Overwrite cells for keys present in ``other`` (same universe or subset).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> old = pw.debug.table_from_markdown('k | v | w\na | 1 | x\nb | 2 | y', id_from=['k'])
        >>> new = pw.debug.table_from_markdown('k | v\nb | 9', id_from=['k'])
        >>> pw.debug.compute_and_print(old.update_cells(new.select(pw.this.v)), include_id=False)
        k | v | w
        a | 1 | x
        b | 9 | y
        """
        extra = set(other.column_names()) - set(self.column_names())
        if extra:
            raise ValueError(f"update_cells: unknown columns {extra}")
        my_names = self.column_names()
        their_names = other.column_names()
        their_pos = {n: i for i, n in enumerate(their_names)}

        def build(lowerer: Lowerer) -> df.Node:
            def merge_fn(lrow, rrow):
                if rrow is None:
                    return lrow
                return tuple(
                    rrow[their_pos[n]] if n in their_pos else lrow[i]
                    for i, n in enumerate(my_names)
                )

            return df.UpdateCellsNode(
                lowerer.scope, lowerer.node(self), lowerer.node(other), merge_fn
            )

        cols = {}
        for n in my_names:
            d = self._schema.__columns__[n].dtype
            if n in their_pos:
                d = dt.types_lca(d, other._schema.__columns__[n].dtype)
            cols[n] = schema_mod.ColumnSchema(name=n, dtype=d)
        return Table(schema_mod.schema_from_columns(cols), build, universe=self._universe)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def intersect(self, *tables: "Table") -> "Table":
        r"""Restrict to rows whose keys appear in every argument table.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('k | v\nx | 1\ny | 2', id_from=['k'])
        >>> b = pw.debug.table_from_markdown('k | w\ny | 9', id_from=['k'])
        >>> pw.debug.compute_and_print(a.intersect(b), include_id=False)
        k | v
        y | 2
        """
        def build(lowerer: Lowerer) -> df.Node:
            return df.IntersectNode(
                lowerer.scope,
                lowerer.node(self),
                [lowerer.node(t) for t in tables],
            )

        return Table(self._schema, build, universe=Universe(parent=self._universe))

    def difference(self, other: "Table") -> "Table":
        r"""Keep rows whose keys do NOT appear in ``other``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> a = pw.debug.table_from_markdown('k | v\nx | 1\ny | 2', id_from=['k'])
        >>> b = pw.debug.table_from_markdown('k | w\ny | 9', id_from=['k'])
        >>> pw.debug.compute_and_print(a.difference(b), include_id=False)
        k | v
        x | 1
        """
        def build(lowerer: Lowerer) -> df.Node:
            return df.IntersectNode(
                lowerer.scope,
                lowerer.node(self),
                [lowerer.node(other)],
                difference=True,
            )

        return Table(self._schema, build, universe=Universe(parent=self._universe))

    def restrict(self, other) -> "Table":
        def build(lowerer: Lowerer) -> df.Node:
            return df.IntersectNode(
                lowerer.scope,
                lowerer.node(self),
                [lowerer.node(other)],
            )

        return Table(self._schema, build, universe=other._universe)

    def having(self, *indexers) -> "Table":
        result = self
        for indexer in indexers:
            if isinstance(indexer, ColumnReference):
                data_table = indexer.table
                key_expr = indexer

                def _mk(data_table=data_table, key_expr=key_expr):
                    view = IxRowView(data_table, _desugar(key_expr, self), optional=True)
                    return view.id.is_not_none()

                result = result.filter(_mk())
        return result

    # -- ix --
    def ix(self, expression, *, optional: bool = False, context=None) -> IxRowView:
        """Row lookup by pointer: read columns of the row ``expression`` points at.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... name  | boss
        ... Alice | Carol
        ... Bob   | Carol
        ... Carol | Carol
        ... ''', id_from=['name'])
        >>> r = t.select(pw.this.name, boss_of_boss=t.ix(t.pointer_from(pw.this.boss)).boss)
        >>> pw.debug.compute_and_print(r, include_id=False)
        name  | boss_of_boss
        Alice | Carol
        Bob   | Carol
        Carol | Carol
        """
        return IxRowView(self, expression, optional=optional)

    def ix_ref(self, *args, optional: bool = False, context=None, instance=None) -> IxRowView:
        key_expr = expr_mod.PointerExpression(self, *args, optional=optional, instance=instance)
        return IxRowView(self, key_expr, optional=optional)

    # -- groupby / reduce --
    def groupby(self, *args, id=None, sort_by=None, instance=None, **kwargs) -> "GroupedTable":
        """Group rows by the given expressions; follow with ``.reduce(...)``.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> res = t.groupby(pw.this.pet).reduce(
        ...     pw.this.pet,
        ...     n=pw.reducers.count(),
        ...     oldest=pw.reducers.max(pw.this.age),
        ... )
        >>> pw.debug.compute_and_print(res, include_id=False)
        pet | n | oldest
        cat | 1 | 3
        dog | 2 | 8
        """
        return GroupedTable(self, args, id=id, sort_by=sort_by, instance=instance)

    def reduce(self, *args, **kwargs) -> "Table":
        """Reduce the whole table to a single row of aggregates.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> pw.debug.compute_and_print(t.reduce(total_age=pw.reducers.sum(pw.this.age)), include_id=False)
        total_age
        16
        """
        return GroupedTable(self, (), id=None).reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value=None,
        instance=None,
        acceptor: Callable[[Any, Any], bool] | None = None,
        persistent_id: str | None = None,
        name: str | None = None,
    ) -> "Table":
        """Keep one accepted row per ``instance``; ``acceptor`` decides replacement.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... k | v  | _time
        ... a | 1  | 2
        ... a | 5  | 4
        ... a | 2  | 6
        ... ''')
        >>> res = t.deduplicate(value=pw.this.v, instance=pw.this.k, acceptor=lambda new, old: new > old)
        >>> pw.debug.compute_and_print(res.select(pw.this.v), include_id=False)
        v
        5
        """
        if value is None:
            raise ValueError("deduplicate requires value=")
        if acceptor is None:
            acceptor = lambda new, old: True  # noqa: E731
        value_e = _desugar(expr_mod._wrap(value), self)
        inst_e = _desugar(expr_mod._wrap(instance), self) if instance is not None else None

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            vf = compile_expr(value_e, binder)
            inf = compile_expr(inst_e, binder) if inst_e is not None else None
            node_in = _fetch_chain(lowerer, base, binder)
            n_cols = len(self.column_names())

            def instance_fn(key, row):
                return inf(key, row) if inf is not None else ()

            def value_fn(key, row):
                return vf(key, row)

            def out_key_fn(inst):
                return hash_values([inst])

            node = df.DeduplicateNode(
                lowerer.scope, node_in, instance_fn, value_fn,
                lambda new, old: acceptor(new, old) if old is not None else True,
                out_key_fn,
            )

            def trim_fn(key, row):
                return row[:n_cols]

            return df.ExprNode(lowerer.scope, node, trim_fn)

        return Table(self._schema, build, universe=Universe())

    # -- sort --
    def sort(self, key, instance=None) -> "Table":
        """Add ``prev``/``next`` pointer columns reflecting the sort order.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown('''
        ... owner | pet  | age
        ... Alice | dog  | 5
        ... Bob   | cat  | 3
        ... Carol | dog  | 8
        ... ''')
        >>> s = t.sort(key=pw.this.age)
        >>> r = t.select(pw.this.owner, next_owner=t.ix(s.next, optional=True).owner)
        >>> pw.debug.compute_and_print(r, include_id=False)
        owner | next_owner
        Alice | Carol
        Bob   | Alice
        Carol | None
        """
        key_e = _desugar(expr_mod._wrap(key), self)
        inst_e = _desugar(expr_mod._wrap(instance), self) if instance is not None else None

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            kf = compile_expr(key_e, binder)
            inf = compile_expr(inst_e, binder) if inst_e is not None else None
            node_in = _fetch_chain(lowerer, base, binder)
            return df.SortNode(
                lowerer.scope,
                node_in,
                lambda key, row: kf(key, row),
                (lambda key, row: inf(key, row)) if inf is not None else (lambda key, row: ()),
            )

        cols = {
            "prev": schema_mod.ColumnSchema(name="prev", dtype=dt.Optional(dt.POINTER)),
            "next": schema_mod.ColumnSchema(name="next", dtype=dt.Optional(dt.POINTER)),
        }
        return Table(schema_mod.schema_from_columns(cols), build, universe=self._universe)

    def diff(self, timestamp, *values, instance=None) -> "Table":
        from pathway_tpu_torch.stdlib.ordered import diff as _diff

        return _diff(self, timestamp, *values, instance=instance)

    # -- typing ops --
    def cast_to_types(self, **kwargs) -> "Table":
        exprs: dict[str, Any] = {
            n: ColumnReference(this, n) for n in self.column_names()
        }
        for n, t in kwargs.items():
            exprs[n] = expr_mod.cast(t, ColumnReference(this, n))
        return self._select_impl(exprs, universe=self._universe)

    @staticmethod
    def empty(**kwargs) -> "Table":
        """An empty table with the schema given by column-name → type kwargs
        (reference table.py:355).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t1 = pw.Table.empty(age=float, pet=float)
        >>> pw.debug.compute_and_print(t1, include_id=False)
        age | pet
        """
        from pathway_tpu_torch.io._utils import make_static_input_table

        return make_static_input_table(
            schema_mod.schema_from_types(**kwargs), []
        )

    @staticmethod
    def from_columns(*args, **kwargs) -> "Table":
        """Build a table from same-universe columns, optionally renamed via
        kwargs (reference table.py:265).

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown("a | b\\n1 | 2")
        >>> t2 = pw.Table.from_columns(t.a, bb=t.b)
        >>> pw.debug.compute_and_print(t2, include_id=False)
        a | bb
        1 | 2
        """
        refs: list[tuple[str, ColumnReference]] = []
        for ref in args:
            refs.append((ref.name, ref))
        for name, ref in kwargs.items():
            refs.append((name, ref))
        if not refs:
            raise ValueError("from_columns requires at least one column")
        names = [n for (n, _r) in refs]
        if len(set(names)) != len(names):
            # silent last-wins would drop a requested column
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"from_columns: duplicate column names {dupes}")
        base = refs[0][1].table
        for _n, r in refs[1:]:
            # is_equal honors promise_are_equal unification, unlike identity
            if not r.table._universe.is_equal(base._universe):
                raise ValueError(
                    "from_columns: all columns must share one universe"
                )
        return base.select(**{n: r for (n, r) in refs})

    def update_id_type(self, id_type, *, id_append_only: bool | None = None) -> "Table":
        """Declare the id column's Pointer type (reference table.py:2003).
        Row keys here are untyped 128-bit hashes, so this is a typing-level
        declaration: it validates the type and returns the same rows."""
        wrapped = dt.wrap(id_type)
        if not (wrapped is dt.POINTER or isinstance(wrapped, dt._Pointer)):
            raise TypeError(f"update_id_type expects a Pointer type, got {id_type!r}")
        return self.copy()

    def eval_type(self, expression) -> "dt.DType":
        """The dtype ``expression`` evaluates to in this table's context
        (reference table.py:2549).  Unknown column references raise;
        operator typing follows this build's (lenient) interpreter.

        Example:

        >>> import pathway_tpu_torch as pw
        >>> t = pw.debug.table_from_markdown("a | b\\n1 | 2")
        >>> t.eval_type(t.a + t.b)
        INT
        """
        wrapped = expr_mod._wrap(expression)
        self._validate_column_refs(wrapped)
        tmp_binder = RowBinder(Lowerer(df.Scope()), self)
        return _infer_dtype(wrapped, tmp_binder)

    def _validate_column_refs(self, e) -> None:
        """Raise KeyError for refs to columns this table does not have —
        the silent ANY fallback of dtype inference must not hide typos in
        the public introspection API."""
        if isinstance(e, ColumnReference):
            tbl = e.table
            if isinstance(tbl, ThisPlaceholder) or tbl is self:
                if e.name != "id" and e.name not in self._schema.__columns__:
                    raise KeyError(
                        f"no column {e.name!r} in this table "
                        f"(has {self.column_names()})"
                    )
            return
        for attr in getattr(e, "__slots__", ()):
            try:
                v = getattr(e, attr)
            except AttributeError:
                continue
            if isinstance(v, ColumnExpression):
                self._validate_column_refs(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, ColumnExpression):
                        self._validate_column_refs(x)

    def update_types(self, **kwargs) -> "Table":
        new_schema = self._schema.update_types(**kwargs)

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)

            class _Retype(df.Node):
                name = "update_types"
                preserves_append_only = True

            return _Retype(lowerer.scope, [base])

        return Table(new_schema, build, universe=self._universe)

    def remove_errors(self) -> "Table":
        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(self)

            def pred(key, row):
                return not any(isinstance(v, Error) for v in row)

            return df.FilterNode(lowerer.scope, base, pred)

        return Table(self._schema, build, universe=Universe(parent=self._universe))

    def await_futures(self) -> "Table":
        return self.copy()

    # -- universe promises --
    def promise_universes_are_equal(self, other: "Table") -> "Table":
        self._universe.unify(other._universe)
        return self

    def promise_universes_are_disjoint(self, other: "Table") -> "Table":
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        self._universe.promise_subset_of(other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        self._universe.unify(other._universe)
        return self

    def with_universe_of(self, other: "Table") -> "Table":
        t = self.copy()
        t._universe = other._universe
        return t

    def is_universe_equal(self, other: "Table") -> bool:
        return self._universe.is_equal(other._universe)

    # -- engine hooks used by stdlib (reference table.py:584-725) --
    def _external_index_as_of_now(
        self,
        index_factory,
        query_table: "Table",
        index_column: ColumnReference,
        query_column: ColumnReference,
        *,
        index_filter_data_column: ColumnReference | None = None,
        query_filter_column: ColumnReference | None = None,
        query_number_of_matches=None,
        query_metadata_column=None,
        res_type=None,
    ) -> "Table":
        data_col_idx = self.column_names().index(index_column.name)
        q_names = query_table.column_names()
        q_col_idx = q_names.index(query_column.name)
        filt_idx = (
            self.column_names().index(index_filter_data_column.name)
            if index_filter_data_column is not None
            else None
        )
        q_filt_idx = (
            q_names.index(query_filter_column.name)
            if query_filter_column is not None
            else None
        )
        q_k_idx = None
        if query_number_of_matches is not None and isinstance(
            query_number_of_matches, ColumnReference
        ):
            q_k_idx = q_names.index(query_number_of_matches.name)
        default_k = (
            query_number_of_matches
            if isinstance(query_number_of_matches, int)
            else None
        )

        def build(lowerer: Lowerer) -> df.Node:
            data_node = lowerer.node(self)
            query_node = lowerer.node(query_table)
            index = index_factory.build()

            class _Idx:
                def add(self, key, row):
                    index.add(
                        key,
                        row[data_col_idx],
                        row[filt_idx] if filt_idx is not None else None,
                    )

                def remove(self, key):
                    index.remove(key)

                def search(self, qrow):
                    k = qrow[q_k_idx] if q_k_idx is not None else default_k
                    return index.search(
                        qrow[q_col_idx],
                        k,
                        qrow[q_filt_idx] if q_filt_idx is not None else None,
                    )

                def search_many(self, qrows):
                    # one bucketed device dispatch per epoch when the
                    # inner index batches (stdlib/indexing KNN does)
                    reqs = [
                        (
                            qrow[q_col_idx],
                            qrow[q_k_idx] if q_k_idx is not None else default_k,
                            qrow[q_filt_idx] if q_filt_idx is not None else None,
                        )
                        for qrow in qrows
                    ]
                    many = getattr(index, "search_many", None)
                    if many is not None:
                        return many(reqs)
                    return [index.search(*req) for req in reqs]

            def res_fn(qkey, qrow, result):
                # result: list[(data_key, score)]
                return (tuple((Pointer(k), s) for k, s in result),)

            return df.ExternalIndexNode(lowerer.scope, data_node, query_node, _Idx(), res_fn)

        cols = {
            "_pw_index_reply": schema_mod.ColumnSchema(
                name="_pw_index_reply",
                dtype=dt.List(dt.Tuple(dt.POINTER, dt.FLOAT)),
            )
        }
        return Table(
            schema_mod.schema_from_columns(cols), build, universe=query_table._universe
        )

    def _gradual_broadcast(self, threshold_table, lower_column, value_column, upper_column) -> "Table":
        names = threshold_table.column_names()
        li, vi, ui = (
            names.index(lower_column.name),
            names.index(value_column.name),
            names.index(upper_column.name),
        )

        def build(lowerer: Lowerer) -> df.Node:
            def lvu_fn(key, row):
                return (row[li], row[vi], row[ui])

            return df.GradualBroadcastNode(
                lowerer.scope, lowerer.node(self), lowerer.node(threshold_table), lvu_fn
            )

        cols = dict(self._schema.__columns__)
        cols["_pw_value"] = schema_mod.ColumnSchema(name="_pw_value", dtype=dt.FLOAT)
        return Table(
            schema_mod.schema_from_columns(cols), build, universe=self._universe
        )

    def _buffer(self, threshold_column, time_column) -> "Table":
        return self._temporal_op(threshold_column, time_column, df.BufferNode)

    def _freeze(self, threshold_column, time_column) -> "Table":
        return self._temporal_op(threshold_column, time_column, df.FreezeNode)

    def _forget(self, threshold_column, time_column, mark_forgetting_records: bool = False) -> "Table":
        return self._temporal_op(threshold_column, time_column, df.ForgetNode)

    def _temporal_op(self, threshold_column, time_column, node_cls) -> "Table":
        thr_e = _desugar(expr_mod._wrap(threshold_column), self)
        time_e = _desugar(expr_mod._wrap(time_column), self)

        def build(lowerer: Lowerer) -> df.Node:
            from pathway_tpu_torch.internals import vector_compiler as vc

            base = lowerer.node(self)
            binder = RowBinder(lowerer, self)
            tf = compile_expr(time_e, binder)
            thf = compile_expr(thr_e, binder)
            node_in = _fetch_chain(lowerer, base, binder)
            node = node_cls(lowerer.scope, node_in, tf, thf)
            # columnar spec: window behaviors lower their time/threshold
            # math to column ± const, so the whole epoch batch's pane
            # admit/expiry arithmetic can run as array ops (the node bails
            # back to tf/thf — the oracle — on anything the arrays cannot
            # honor exactly)
            spec_t = vc.affine_index(time_e, binder)
            spec_thr = vc.affine_index(thr_e, binder)
            if spec_t is not None and spec_thr is not None:
                node.vec_temporal = (*spec_t, *spec_thr)
            return _trim_if_needed(lowerer, node, binder, len(self.column_names()))

        return Table(self._schema, build, universe=Universe(parent=self._universe))

    # -- output --
    def to(self, sink) -> None:
        sink.write(self)

    def debug(self, name: str) -> "Table":
        from pathway_tpu_torch.internals.runner import add_debug_sink

        add_debug_sink(name, self)
        return self

    def _subscribe_raw(self, on_data, on_time_end=None, on_end=None, keep_state=False, name="subscribe"):
        """Register a raw sink; on_data(key, row, time, diff)."""

        def attach(lowerer: Lowerer, node: df.Node):
            out = df.OutputNode(
                lowerer.scope, node, on_data=on_data, on_time_end=on_time_end, on_end=on_end
            )
            if keep_state:
                out.require_state()
            return out

        G.add_sink(name, self, attach)


# ---------------------------------------------------------------------------
# TableSlice
# ---------------------------------------------------------------------------


class TableSlice:
    def __init__(self, table: Table, names: list[str]):
        self._table = table
        self._names = names

    def column_names(self) -> list[str]:
        return self._names

    def keys(self):
        return self._names

    def without(self, *cols) -> "TableSlice":
        drop = {c if isinstance(c, str) else c.name for c in cols}
        return TableSlice(self._table, [n for n in self._names if n not in drop])

    def with_prefix(self, prefix: str) -> "TableSlice":
        return self.rename({n: prefix + n for n in self._names})

    def with_suffix(self, suffix: str) -> "TableSlice":
        return self.rename({n: n + suffix for n in self._names})

    def rename(self, mapping: Mapping) -> "TableSlice":
        # produces a slice carrying rename info; materialized via select
        new = TableSlice(self._table, list(self._names))
        new._renames = {  # type: ignore[attr-defined]
            (k.name if isinstance(k, ColumnReference) else k): v for k, v in mapping.items()
        }
        return new

    def __iter__(self):
        return iter(ColumnReference(self._table, n) for n in self._names)

    def __getitem__(self, name):
        if isinstance(name, ColumnReference):
            name = name.name
        return ColumnReference(self._table, name)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._names:
            return ColumnReference(self._table, name)
        raise AttributeError(name)

    @property
    def id(self):
        return ColumnReference(self._table, "id")


# ---------------------------------------------------------------------------
# GroupedTable
# ---------------------------------------------------------------------------


class GroupedTable:
    def __init__(self, table: Table, grouping: Sequence[Any], id=None, sort_by=None, instance=None):
        self._table = table
        self._id_param = id
        self._instance = instance
        self._sort_by = sort_by
        gcols: list[ColumnReference] = []
        for g in grouping:
            if isinstance(g, ColumnReference):
                gcols.append(g)
            elif isinstance(g, str):
                gcols.append(ColumnReference(this, g))
            else:
                raise TypeError(f"groupby expects column references, got {type(g)}")
        if id is not None:
            # groupby(id=t.id) groups by row id
            gcols = [id if isinstance(id, ColumnReference) else ColumnReference(this, "id")]
        self._gcols = gcols

    def reduce(self, *args, **kwargs) -> Table:
        table = self._table
        exprs = _expand_args(args, table)
        exprs.update(kwargs)
        desugared = {n: _desugar(expr_mod._wrap(e), table) for n, e in exprs.items()}
        g_exprs = [_desugar(g, table) for g in self._gcols]
        inst_expr = (
            _desugar(expr_mod._wrap(self._instance), table)
            if self._instance is not None
            else None
        )
        g_names = [g.name if isinstance(g, ColumnReference) else None for g in self._gcols]
        grouped_by_id = self._id_param is not None

        # split each output expression into reducer slots + outer expr
        slots: list[ReducerExpression] = []

        class _SlotRef(ColumnReference):
            # subclassing ColumnReference routes nested slots through the
            # evaluator's binder.resolve path
            __slots__ = ("_slot",)

            def __init__(self, slot):
                super().__init__(None, f"__slot_{slot}__")
                self._slot = slot

            def _substitute(self, mapping):
                return self

            def _infer_dtype(self, resolver):
                return resolver(self)

        def extract_reducers(e: ColumnExpression) -> ColumnExpression:
            if isinstance(e, ReducerExpression):
                slots.append(e)
                return _SlotRef(len(slots) - 1)
            subs = list(e._sub_expressions())
            if not subs:
                return e
            # rebuild via substitute trick: substitute doesn't handle this case,
            # so walk manually for known composite types
            new = e._substitute({})
            # replace sub-expressions in the rebuilt copy
            _replace_subs(new, extract_reducers)
            return new

        def _replace_subs(e, fn):
            for attr in getattr(e, "__slots__", ()):  # mutate in place
                try:
                    v = getattr(e, attr)
                except AttributeError:
                    continue
                if isinstance(v, ReducerExpression):
                    slots.append(v)
                    object.__setattr__(e, attr, _SlotRef(len(slots) - 1))
                elif isinstance(v, ColumnExpression):
                    _replace_subs(v, fn)
                elif isinstance(v, tuple) and any(isinstance(x, ColumnExpression) for x in v):
                    new_items = []
                    for x in v:
                        if isinstance(x, ReducerExpression):
                            slots.append(x)
                            new_items.append(_SlotRef(len(slots) - 1))
                        else:
                            if isinstance(x, ColumnExpression):
                                _replace_subs(x, fn)
                            new_items.append(x)
                    object.__setattr__(e, attr, tuple(new_items))
                elif isinstance(v, dict):
                    for k2, x in list(v.items()):
                        if isinstance(x, ReducerExpression):
                            slots.append(x)
                            v[k2] = _SlotRef(len(slots) - 1)
                        elif isinstance(x, ColumnExpression):
                            _replace_subs(x, fn)

        outer_exprs: dict[str, ColumnExpression] = {}
        for n, e in desugared.items():
            if isinstance(e, ReducerExpression):
                slots.append(e)
                outer_exprs[n] = _SlotRef(len(slots) - 1)
            else:
                copy = e._substitute({})
                _replace_subs(copy, extract_reducers)
                outer_exprs[n] = copy

        n_group = len(g_exprs) + (1 if inst_expr is not None else 0)

        class GroupBinder(Binder):
            """Resolves refs over the synthetic (gk..., slot values...) row."""

            def __init__(self, inner_binder):
                self.inner = inner_binder

            def resolve(self, ref):
                if isinstance(ref, _SlotRef):
                    idx = n_group + ref._slot
                    return lambda key, row: row[idx]
                name = ref.name
                if grouped_by_id and name == "id":
                    return lambda key, row: row[0]
                if name in g_names:
                    idx = g_names.index(name)
                    return lambda key, row: row[idx]
                if name == "id":
                    return lambda key, row: Pointer(key)
                raise KeyError(
                    f"column {name!r} used in reduce() is not a grouping column; "
                    "wrap it in a reducer"
                )

            def resolve_dtype(self, ref):
                return self.inner.resolve_dtype(ref)

        # patch compile for _SlotRef
        def compile_group_expr(e, gbinder):
            if isinstance(e, _SlotRef):
                return gbinder.resolve(e)
            if isinstance(e, ColumnReference):
                return gbinder.resolve(e)
            # recurse via evaluator with gbinder as Binder
            return compile_expr(e, gbinder)

        def build(lowerer: Lowerer) -> df.Node:
            base = lowerer.node(table)
            binder = RowBinder(lowerer, table)
            g_fns = [compile_expr(g, binder) for g in g_exprs]
            inst_fn = compile_expr(inst_expr, binder) if inst_expr is not None else None
            reducer_specs = []
            for r in slots:
                arg_fns = [compile_expr(a, binder) for a in r._args]
                if not arg_fns:
                    reducer_specs.append((r._reducer, lambda key, row: ()))
                else:
                    reducer_specs.append(
                        (
                            r._reducer,
                            (lambda fns: lambda key, row: tuple(f(key, row) for f in fns))(
                                arg_fns
                            ),
                        )
                    )
            node_in = _fetch_chain(lowerer, base, binder)

            def group_key_fn(key, row):
                gk = tuple(f(key, row) for f in g_fns)
                if grouped_by_id:
                    gk = (Pointer(key),)
                if inst_fn is not None:
                    gk = gk + (inst_fn(key, row),)
                return gk

            def out_key_fn(gk):
                if grouped_by_id:
                    return gk[0].value
                return hash_values(list(gk))

            gbinder = GroupBinder(binder)
            out_fns = [
                compile_group_expr(e, gbinder) for e in outer_exprs.values()
            ]
            out_dtypes = [new_schema.__columns__[n].dtype for n in outer_exprs]

            def result_fn(gk, vals):
                row = tuple(gk) + tuple(vals)
                okey = out_key_fn(gk)
                return tuple(
                    dt.coerce(f(okey, row), d) for f, d in zip(out_fns, out_dtypes)
                )

            gb_node = df.GroupByNode(
                lowerer.scope,
                node_in,
                group_key_fn,
                out_key_fn,
                reducer_specs,
                result_fn,
            )
            gb_node.vec_group = _vec_group_spec(
                g_exprs, inst_expr, grouped_by_id, slots, binder
            )
            key_idxs = _group_key_idxs(g_exprs, inst_expr, grouped_by_id, binder)
            if key_idxs is not None:
                # batched exchange routing: the group route key is
                # hash_values over exactly these column values, so the
                # per-row route loop collapses to one native pass
                # (hash_none=True: group keys hash Nones like any value)
                gb_node.exchange_route_cols = {0: (key_idxs, True)}
            return gb_node

        def _plain_col_idx(e, binder):
            from pathway_tpu_torch.internals.thisclass import ThisPlaceholder

            if not isinstance(e, ColumnReference):
                return None
            if not (isinstance(e.table, ThisPlaceholder) or e.table is binder.table):
                return None
            if e.name == "id" or e.name not in binder.col_index:
                return None
            return binder.col_index[e.name]

        def _group_key_idxs(g_exprs, inst_expr, grouped_by_id, binder):
            """Column indices whose row values ARE the group key tuple (in
            group-key order, instance last) — None when any key is not a
            plain same-table column."""
            if grouped_by_id or not g_exprs:
                return None
            idxs = [_plain_col_idx(e, binder) for e in g_exprs]
            if inst_expr is not None:
                idxs.append(_plain_col_idx(inst_expr, binder))
            if any(i is None for i in idxs):
                return None
            return tuple(idxs)

        def _vec_group_spec(g_exprs, inst_expr, grouped_by_id, slots, binder):
            """Columnar groupby spec (GroupByNode.vec_group) when the shape
            allows it: plain grouping columns (instance included — it is
            just one more key column), count/sum/avg/min/max reducers over
            plain columns.  Anything else keeps the row path."""
            from pathway_tpu_torch.internals.reducers import (
                AvgReducer,
                CountReducer,
                SumReducer,
            )

            def plain_idx(e):
                return _plain_col_idx(e, binder)

            g_idxs = _group_key_idxs(g_exprs, inst_expr, grouped_by_id, binder)
            if g_idxs is None:
                return None
            # single-column groups keep the scalar spec (numpy unique /
            # native raw grouping); multi-column groups hash-group tuples
            gidx = g_idxs[0] if len(g_idxs) == 1 else g_idxs
            red_cols = []
            for r in slots:
                red = r._reducer
                # isinstance: count is exported as a _CountCallable subclass
                if isinstance(red, CountReducer) and not r._args:
                    red_cols.append(("count", None))
                    continue
                if type(red) in (SumReducer, AvgReducer) and len(r._args) == 1:
                    vidx = plain_idx(r._args[0])
                    if vidx is not None:
                        red_cols.append(("sum", vidx))
                        continue
                from pathway_tpu_torch.internals import reducers as _red_mod

                # identity against the public singletons: a user reducer
                # merely NAMED "min" must not be routed to the mm path
                if red in (_red_mod.min, _red_mod.max) and len(r._args) == 1:
                    vidx = plain_idx(r._args[0])
                    if vidx is not None:
                        # multiset pair update; extraction stays in the state
                        red_cols.append(("mm", vidx))
                        continue
                return None
            return (gidx, red_cols)

        # schema inference
        tmp_binder = RowBinder(Lowerer(df.Scope()), table)
        gb = None

        def type_resolver(ref):
            if isinstance(ref, _SlotRef):
                return slots[ref._slot]._infer_dtype(tmp_binder.resolve_dtype)
            return tmp_binder.resolve_dtype(ref)

        cols = {}
        for n, e in outer_exprs.items():
            try:
                cols[n] = schema_mod.ColumnSchema(name=n, dtype=e._infer_dtype(type_resolver))
            except Exception:
                cols[n] = schema_mod.ColumnSchema(name=n, dtype=dt.ANY)
        new_schema = schema_mod.schema_from_columns(cols)
        universe = table._universe if grouped_by_id else Universe()
        return Table(new_schema, build, universe=universe)


# ---------------------------------------------------------------------------
# JoinResult
# ---------------------------------------------------------------------------


from pathway_tpu_torch.internals.thisclass import left as left_ph, right as right_ph


class JoinResult(Joinable):
    def __init__(self, left_t, right_t, on: Sequence[Any], mode: JoinMode, id=None):
        # left_t/right_t may be JoinResult (chained joins): materialize first
        if isinstance(left_t, JoinResult):
            left_t = left_t._as_table()
        if isinstance(right_t, JoinResult):
            right_t = right_t._as_table()
        self._left = left_t
        self._right = right_t
        self._mode = mode
        self._id_param = id
        self._left_on: list[ColumnExpression] = []
        self._right_on: list[ColumnExpression] = []
        for cond in on:
            if not isinstance(cond, expr_mod.ColumnBinaryOpExpression) or cond._op != "==":
                raise ValueError("join conditions must be equalities (a == b)")
            l_e, r_e = cond._left, cond._right
            if self._refers(r_e, self._left) and self._refers(l_e, self._right):
                l_e, r_e = r_e, l_e
            self._left_on.append(
                l_e._substitute({_object_id(left_ph): self._left, _object_id(this): self._left})
            )
            self._right_on.append(
                r_e._substitute({_object_id(right_ph): self._right, _object_id(this): self._right})
            )

    @staticmethod
    def _refers(e: ColumnExpression, table: Table) -> bool:
        if isinstance(e, ColumnReference):
            if e.table is table:
                return True
            if isinstance(e.table, ThisPlaceholder):
                return False
        for sub in e._sub_expressions():
            if JoinResult._refers(sub, table):
                return True
        return False

    @staticmethod
    def _side_of(tbl, left_table, right_table) -> str | None:
        """'left'/'right'/None — the ONE left/right/ThisPlaceholder
        dispatch rule shared by out_key_fn, the native okey-mode
        detection and the projection spec (they must never desync)."""
        if tbl is left_table or (
            isinstance(tbl, ThisPlaceholder) and tbl._kind == "left"
        ):
            return "left"
        if tbl is right_table or (
            isinstance(tbl, ThisPlaceholder) and tbl._kind == "right"
        ):
            return "right"
        return None

    def _lower_join(self, lowerer: Lowerer) -> df.JoinNode:
        lnode = lowerer.node(self._left)
        rnode = lowerer.node(self._right)
        lbinder = RowBinder(lowerer, self._left)
        rbinder = RowBinder(lowerer, self._right)
        l_fns = [compile_expr(e, lbinder) for e in self._left_on]
        r_fns = [compile_expr(e, rbinder) for e in self._right_on]
        lnode = _fetch_chain(lowerer, lnode, lbinder)
        rnode = _fetch_chain(lowerer, rnode, rbinder)

        def none_guard(fns):
            def f(key, row):
                vals = tuple(fn(key, row) for fn in fns)
                if any(v is None or isinstance(v, Error) for v in vals):
                    return None  # null join keys never match (SQL semantics)
                return vals

            return f

        id_param = self._id_param
        left_table, right_table = self._left, self._right

        id_side = None
        if (
            id_param is not None
            and isinstance(id_param, ColumnReference)
            and id_param.name == "id"
        ):
            id_side = JoinResult._side_of(id_param.table, left_table, right_table)

        def out_key_fn(lkey, rkey, jk):
            if id_side == "left":
                return lkey if lkey is not None else hash_values([None, rkey])
            if id_side == "right":
                return rkey if rkey is not None else hash_values([lkey, None])
            return hash_values(
                [
                    Pointer(lkey) if lkey is not None else None,
                    Pointer(rkey) if rkey is not None else None,
                ]
            )

        node = df.JoinNode(
            lowerer.scope,
            lnode,
            rnode,
            none_guard(l_fns),
            none_guard(r_fns),
            out_key_fn,
            left_outer=self._mode in (JoinMode.LEFT, JoinMode.OUTER),
            right_outer=self._mode in (JoinMode.RIGHT, JoinMode.OUTER),
        )
        from pathway_tpu_torch.internals import vector_compiler as vc

        # plain-column equi-joins run the whole delta-join step in the
        # native C++ index (reference join hot path, dataflow.rs:2740);
        # okey modes mirror out_key_fn above exactly.  Outer modes are
        # supported for the default hash-pair out keys (modes 1/2 with
        # a nullable counterpart keep the row path: their null-pad key
        # derivation serializes the RAW key, a distinct recipe).
        l_idxs = [vc.passthrough_index(e, lbinder) for e in self._left_on]
        r_idxs = [vc.passthrough_index(e, rbinder) for e in self._right_on]

        def _hashable_key_dtypes() -> bool:
            """The native index matches by serialized bytes; the row
            path by Python equality.  They agree only for same-dtype
            keys whose equality is byte equality: int/str/bytes/bool/
            Pointer.  Floats are out (-0.0 == 0.0 with different
            bytes, nan != nan with equal bytes); cross-dtype pairs
            are out (True == 1, 1 == 1.0 across columns)."""
            exact = {dt.INT, dt.STR, dt.BYTES, dt.BOOL, dt.POINTER}
            for le, re_ in zip(self._left_on, self._right_on):
                lcol = left_table.schema.__columns__.get(le.name)
                rcol = right_table.schema.__columns__.get(re_.name)
                if lcol is None or rcol is None:
                    return False
                ld = lcol.dtype.strip_optional()
                rd = rcol.dtype.strip_optional()
                if ld is not rd or ld not in exact:
                    return False
            return True

        mode = {"left": 1, "right": 2}.get(id_side, 0)
        outer = self._mode is not JoinMode.INNER
        if (
            vc.ENABLED
            and l_idxs
            and None not in l_idxs
            and None not in r_idxs
            and _hashable_key_dtypes()
            and not (outer and mode != 0)
        ):
            node.native_spec = (tuple(l_idxs), tuple(r_idxs), mode)
        if vc.ENABLED and l_idxs and None not in l_idxs and None not in r_idxs:
            # batched exchange routing: the route key is hash_values over
            # the raw join-key column values (none_guard semantics: a
            # None/Error key value routes the row by its own key), which
            # the native route kernel reproduces byte-for-byte — no
            # dtype gate needed, unlike the index fast path above
            node.exchange_route_cols = {
                0: (tuple(l_idxs), False),
                1: (tuple(r_idxs), False),
            }
        return node

    def select(self, *args, **kwargs) -> Table:
        exprs: dict[str, Any] = {}
        for a in args:
            if isinstance(a, ThisSlice):
                base = a._base
                if getattr(base, "_kind", None) == "left":
                    for n in a._column_names(self._left):
                        exprs[n] = ColumnReference(left_ph, n)
                elif getattr(base, "_kind", None) == "right":
                    for n in a._column_names(self._right):
                        exprs[n] = ColumnReference(right_ph, n)
                else:
                    all_names = self._all_names()
                    for n in (a._keep if a._keep is not None else all_names):
                        if n not in a._without:
                            exprs[n] = ColumnReference(this, n)
            elif isinstance(a, TableSlice):
                for n in a.column_names():
                    exprs[n] = ColumnReference(a._table, n)
            else:
                exprs[_name_of_expr(a)] = a
        exprs.update(kwargs)
        return self._select_impl(exprs)

    def _all_names(self) -> list[str]:
        names = list(self._left.column_names())
        for n in self._right.column_names():
            if n not in names:
                names.append(n)
        return names

    def _as_table(self) -> Table:
        exprs: dict[str, Any] = {}
        l_names = set(self._left.column_names())
        r_names = set(self._right.column_names())
        for n in self._left.column_names():
            exprs[n] = ColumnReference(left_ph, n)
        for n in self._right.column_names():
            if n in l_names:
                continue  # left wins on collision for the implicit projection
            exprs[n] = ColumnReference(right_ph, n)
        return self._select_impl(exprs)

    def filter(self, expression) -> Table:
        return self._as_table().filter(expression)

    def groupby(self, *args, **kwargs):
        return self._as_table().groupby(*args, **kwargs)

    def reduce(self, *args, **kwargs) -> Table:
        return self._as_table().reduce(*args, **kwargs)

    def _select_impl(self, exprs: Mapping[str, Any]) -> Table:
        left_table, right_table = self._left, self._right
        mode = self._mode

        class JoinBinder(Binder):
            def __init__(self, lowerer):
                self.lowerer = lowerer
                self.l_names = left_table.column_names()
                self.r_names = right_table.column_names()
                self.n_l = len(self.l_names)

            def _left_acc(self, name):
                if name == "id":
                    return lambda key, row: (
                        Pointer(row[0]) if row[0] is not None else None
                    )
                idx = self.l_names.index(name)
                return lambda key, row: (row[2][idx] if row[2] is not None else None)

            def _right_acc(self, name):
                if name == "id":
                    return lambda key, row: (
                        Pointer(row[1]) if row[1] is not None else None
                    )
                idx = self.r_names.index(name)
                return lambda key, row: (row[3][idx] if row[3] is not None else None)

            def resolve(self, ref):
                tbl, name = ref.table, ref.name
                if tbl is left_table or (
                    isinstance(tbl, ThisPlaceholder) and tbl._kind == "left"
                ):
                    return self._left_acc(name)
                if tbl is right_table or (
                    isinstance(tbl, ThisPlaceholder) and tbl._kind == "right"
                ):
                    return self._right_acc(name)
                if isinstance(tbl, ThisPlaceholder):  # pw.this — search both
                    if name == "id":
                        return lambda key, row: Pointer(key)
                    in_l = name in self.l_names
                    in_r = name in self.r_names
                    if in_l and in_r:
                        raise ValueError(
                            f"column {name!r} is ambiguous in join select; "
                            "use pw.left/pw.right"
                        )
                    if in_l:
                        return self._left_acc(name)
                    if in_r:
                        return self._right_acc(name)
                    raise KeyError(name)
                if isinstance(tbl, Table):
                    raise ValueError(
                        "references to third tables in join select are not supported; "
                        "join with that table instead"
                    )
                raise ValueError(f"cannot resolve {ref!r}")

            def resolve_dtype(self, ref):
                tbl, name = ref.table, ref.name
                opt_l = mode in (JoinMode.RIGHT, JoinMode.OUTER)
                opt_r = mode in (JoinMode.LEFT, JoinMode.OUTER)

                def maybe_opt(t, make_opt):
                    return dt.Optional(t) if make_opt else t

                if tbl is left_table or (
                    isinstance(tbl, ThisPlaceholder) and tbl._kind == "left"
                ):
                    if name == "id":
                        return maybe_opt(dt.POINTER, opt_l)
                    col = left_table.schema.__columns__.get(name)
                    return maybe_opt(col.dtype if col else dt.ANY, opt_l)
                if tbl is right_table or (
                    isinstance(tbl, ThisPlaceholder) and tbl._kind == "right"
                ):
                    if name == "id":
                        return maybe_opt(dt.POINTER, opt_r)
                    col = right_table.schema.__columns__.get(name)
                    return maybe_opt(col.dtype if col else dt.ANY, opt_r)
                if isinstance(tbl, ThisPlaceholder):
                    if name in left_table.schema.__columns__:
                        return maybe_opt(
                            left_table.schema.__columns__[name].dtype, opt_l
                        )
                    if name in right_table.schema.__columns__:
                        return maybe_opt(
                            right_table.schema.__columns__[name].dtype, opt_r
                        )
                return dt.ANY

        jr = self

        def _project_spec():
            """((src, idx), ...) when every output is a plain left/right
            column or id pick — the native join projection's contract
            (srcs: 0 lrow[idx], 1 rrow[idx], 2/3 left/right id, 4 out id).
            None when any expression needs the row interpreter."""
            l_names = left_table.column_names()
            r_names = right_table.column_names()
            spec = []
            for e in exprs.values():
                if not isinstance(e, ColumnReference):
                    return None
                tbl, name = e.table, e.name
                side = JoinResult._side_of(tbl, left_table, right_table)
                if side is None and isinstance(tbl, ThisPlaceholder):
                    if name == "id":
                        spec.append((4, -1))
                        continue
                    in_l, in_r = name in l_names, name in r_names
                    if in_l and in_r:
                        return None  # ambiguity error stays on the row path
                    side = "left" if in_l else ("right" if in_r else None)
                if side == "left":
                    spec.append((2, -1) if name == "id" else (0, l_names.index(name)))
                elif side == "right":
                    spec.append((3, -1) if name == "id" else (1, r_names.index(name)))
                else:
                    return None
            return tuple(spec)

        def _flat_select() -> "Table | None":
            """Computed join-selects as: native flat projection of every
            REFERENCED side column → a standard (vec-compilable) select
            over the flat table.  The join step and the column extraction
            stay native; only the arithmetic runs in the expression
            engine — which vectorizes it.  None = unsupported shape (the
            row path handles it, including its error surfaces)."""
            l_names = left_table.column_names()
            r_names = right_table.column_names()
            refs: list[ColumnReference] = []

            def walk(e):
                if isinstance(e, ColumnReference):
                    refs.append(e)
                    return
                for s in e._sub_expressions():
                    walk(s)

            for e in exprs.values():
                if not isinstance(e, expr_mod.ColumnExpression):
                    return None
                walk(e)

            needed: dict[str, tuple[int, int]] = {}  # name -> (src, idx)
            sides: dict[str, str] = {}
            for ref in refs:
                name = ref.name
                if name == "id":
                    return None  # id refs keep the row path
                side = JoinResult._side_of(ref.table, left_table, right_table)
                if side is None and isinstance(ref.table, ThisPlaceholder):
                    in_l, in_r = name in l_names, name in r_names
                    if in_l == in_r:
                        return None  # ambiguous / unknown: row path raises
                    side = "left" if in_l else "right"
                if side is None:
                    return None
                if sides.get(name, side) != side:
                    return None  # same name from both sides: would collide
                sides[name] = side
                if name not in needed:
                    src = 0 if side == "left" else 1
                    names_ = l_names if side == "left" else r_names
                    if name not in names_:
                        return None
                    needed[name] = (src, names_.index(name))
            if not needed:
                return None

            flat_names = list(needed)
            spec = tuple(needed[n] for n in flat_names)
            tmp = JoinBinder(None)
            cols = {}
            for n in flat_names:
                side_tbl = left_table if sides[n] == "left" else right_table
                try:
                    d = tmp.resolve_dtype(ColumnReference(side_tbl, n))
                except Exception:
                    d = dt.ANY
                cols[n] = schema_mod.ColumnSchema(name=n, dtype=d)

            def flat_build(lowerer: Lowerer) -> df.Node:
                join_node = jr._lower_join(lowerer)
                binder = JoinBinder(lowerer)
                accs = [
                    binder.resolve(
                        ColumnReference(
                            left_ph if sides[n] == "left" else right_ph, n
                        )
                    )
                    for n in flat_names
                ]

                def fn(key, row):
                    return tuple(a(key, row) for a in accs)

                node = df.ExprNode(lowerer.scope, join_node, fn)
                node.vec_join_project = spec
                return node

            flat_t = Table(
                schema_mod.schema_from_columns(cols), flat_build, universe=Universe()
            )
            mapping = {
                id(left_table): flat_t,
                id(right_table): flat_t,
                id(left_ph): flat_t,
                id(right_ph): flat_t,
                id(this): flat_t,
            }
            return flat_t.select(
                **{n: e._substitute(mapping) for n, e in exprs.items()}
            )

        def build(lowerer: Lowerer) -> df.Node:
            join_node = jr._lower_join(lowerer)
            binder = JoinBinder(lowerer)
            fns = [compile_expr(e, binder) for e in exprs.values()]

            def fn(key, row):
                return tuple(f(key, row) for f in fns)

            node = df.ExprNode(lowerer.scope, join_node, fn)
            node.vec_join_project = _project_spec()
            return node

        from pathway_tpu_torch.internals import vector_compiler as _vc

        if _vc.ENABLED and _project_spec() is None:
            # only worthwhile with the vector compiler on (the flat graph
            # adds a node whose payoff is the columnar expression pass);
            # off also serves as the parity toggle for tests
            flat = _flat_select()
            if flat is not None:
                return flat

        tmp_binder = JoinBinder(None)
        cols = {}
        for n, e in exprs.items():
            e_w = expr_mod._wrap(e)
            try:
                d = e_w._infer_dtype(tmp_binder.resolve_dtype)
            except Exception:
                d = dt.ANY
            cols[n] = schema_mod.ColumnSchema(name=n, dtype=d)
        return Table(schema_mod.schema_from_columns(cols), build, universe=Universe())


# convenience top-level functions mirroring pw.join / pw.groupby
def join(left_t, right_t, *on, id=None, how=JoinMode.INNER, **kw):
    return left_t.join(right_t, *on, id=id, how=how)


def join_inner(left_t, right_t, *on, **kw):
    return left_t.join_inner(right_t, *on, **kw)


# Typed aliases for reference API parity (reference exports distinct
# GroupedJoinResult / OuterJoinResult classes from groupbys.py/joins.py;
# here joins of every mode share JoinResult and groupby-after-join goes
# through GroupedTable, so the names bind to those implementations).
GroupedJoinResult = GroupedTable
OuterJoinResult = JoinResult


def join_left(left_t, right_t, *on, **kw):
    return left_t.join_left(right_t, *on, **kw)


def join_right(left_t, right_t, *on, **kw):
    return left_t.join_right(right_t, *on, **kw)


def join_outer(left_t, right_t, *on, **kw):
    return left_t.join_outer(right_t, *on, **kw)


def groupby(table, *args, **kwargs):
    return table.groupby(*args, **kwargs)


TableLike = Table


# ---------------------------------------------------------------------------
# user-frame tracing on the public entry points (reference trace.py:123-131:
# the decorator is applied at each method there; applying it here in one
# sweep keeps the method bodies free of wrapper noise)
# ---------------------------------------------------------------------------

from pathway_tpu_torch.internals.trace import trace_user_frame as _trace_user_frame  # noqa: E402

_TRACED_TABLE_METHODS = (
    "select", "with_columns", "without", "rename", "rename_columns",
    "rename_by_dict", "with_prefix", "with_suffix", "filter", "split",
    "flatten", "pointer_from", "with_id_from", "with_id", "concat",
    "concat_reindex", "update_rows", "update_cells", "intersect",
    "difference", "restrict", "having", "ix", "ix_ref", "groupby",
    "reduce", "deduplicate", "sort", "diff", "cast_to_types",
    "update_types", "join", "join_inner", "join_left", "join_right",
    "join_outer", "with_universe_of",
)

for _cls in (Table, GroupedTable, JoinResult, Joinable):
    for _name in _TRACED_TABLE_METHODS:
        _fn = _cls.__dict__.get(_name)
        if callable(_fn) and not isinstance(_fn, (property, staticmethod, classmethod)):
            setattr(_cls, _name, _trace_user_frame(_fn))
