"""``pw.iterate`` — fixed-point computation.

Parity target: ``parse_graph.py:157-181`` (IterateOperator) +
``dataflow.rs:4185-4724``.  The body function receives proxy tables bound to
a nested engine scope; tables returned under the same keyword are fed back
until quiescence (semi-naive, per outer epoch), as in differential's
iterative scopes.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe


class _IterationProxyTable(Table):
    """Table bound to an iteration input inside the nested scope."""

    def __init__(self, schema, node_getter):
        super().__init__(schema, build=lambda lowerer: node_getter(lowerer), universe=Universe())


class _IterSubLowerer(Lowerer):
    """Lowerer for the iteration subscope.

    Tables created by the body build in the subscope; any other table is an
    outer-scope collection — it lowers in the OUTER scope and streams into
    the subscope through an import InputNode (the reference's scope
    import/export, dataflow.rs:4315-4724).
    """

    def __init__(self, subscope, outer_lowerer, marker: int, import_pairs: list):
        super().__init__(subscope)
        self._outer = outer_lowerer
        self._marker = marker  # G.tables index where the body started
        self._scan = marker
        self._inside_ids: set[int] = set()
        self._imports = import_pairs

    def _is_inside(self, table) -> bool:
        tables = parse_graph.G.tables
        while self._scan < len(tables):
            self._inside_ids.add(id(tables[self._scan]))
            self._scan += 1
        return id(table) in self._inside_ids

    def node(self, table) -> df.Node:
        key = id(table)
        if key in self.memo:
            return self.memo[key]
        if self._is_inside(table):
            self.memo[key] = table._build(self)
            return self.memo[key]
        outer_node = self._outer.node(table)
        sub_in = df.InputNode(self.scope)
        self._imports.append((outer_node, sub_in))
        self.memo[key] = sub_in
        return sub_in


def iterate(func: Callable, iteration_limit: int | None = None, **kwargs: Table):
    r"""Iterate ``func`` to fixed point.

    ``kwargs`` are input tables; ``func(**tables)`` returns a dict (or
    dataclass/namedtuple) of tables.  Returned keys matching input names are
    fed back for the next round; the fixed point of each returned table is
    the result.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> def collatz(t):
    ...     return t.select(
    ...         v=pw.if_else(
    ...             pw.this.v == 1, 1,
    ...             pw.if_else(pw.this.v % 2 == 0, pw.this.v // 2, 3 * pw.this.v + 1),
    ...         )
    ...     )
    >>> t = pw.debug.table_from_markdown('v\n6\n27')
    >>> res = pw.iterate(collatz, t=t)
    >>> pw.debug.compute_and_print(res, include_id=False)
    v
    1
    1
    """
    input_names = list(kwargs.keys())
    input_tables = [kwargs[n] for n in input_names]

    # results are produced lazily: a recipe that builds the IterateNode once
    holder: dict[str, Any] = {}

    def ensure_built(lowerer: Lowerer) -> dict[str, df.Node]:
        cache_key = id(lowerer)
        if holder.get("lowerer_id") == cache_key:
            return holder["result_nodes_by_name"]

        outer_nodes = [lowerer.node(t) for t in input_tables]
        result_order: list[str] = []

        def build_body(subscope: df.Scope, iter_inputs: list[df.InputNode]):
            import_pairs: list = []
            marker = len(parse_graph.G.tables)
            sub_lowerer = _IterSubLowerer(subscope, lowerer, marker, import_pairs)
            proxies = {}
            for name, table, iin in zip(input_names, input_tables, iter_inputs):
                proxy = _IterationProxyTable(table.schema, lambda lw, _iin=iin: _iin)
                sub_lowerer.memo[id(proxy)] = iin
                proxies[name] = proxy
            returned = func(**proxies)
            if isinstance(returned, Table):
                returned = {input_names[0]: returned}
            elif not isinstance(returned, dict):
                # dataclass / namedtuple
                if hasattr(returned, "_asdict"):
                    returned = returned._asdict()
                else:
                    returned = {
                        k: v for k, v in vars(returned).items() if isinstance(v, Table)
                    }
            result_order.extend(returned.keys())
            holder["returned_schemas"] = {k: v.schema for k, v in returned.items()}
            result_nodes = [sub_lowerer.node(t) for t in returned.values()]
            back_pairs = []
            for n in input_names:
                if n in returned:
                    back_pairs.append((input_names.index(n), sub_lowerer.node(returned[n])))
            return result_nodes, back_pairs, import_pairs

        node = df.IterateNode(
            lowerer.scope, outer_nodes, build_body, limit=iteration_limit
        )

        result_nodes_by_name = {}
        for i, name in enumerate(result_order):
            result_nodes_by_name[name] = df.IterateResultNode(lowerer.scope, node, i)
        holder["lowerer_id"] = cache_key
        holder["result_nodes_by_name"] = result_nodes_by_name
        return result_nodes_by_name

    # trial build to learn the returned table names/schemas (pure, on a
    # throwaway scope)
    trial_lowerer = Lowerer(df.Scope())
    trial_nodes = ensure_built(trial_lowerer)
    schemas = holder["returned_schemas"]

    results = {}
    for name in trial_nodes:
        def make_build(n=name):
            def build(lowerer: Lowerer) -> df.Node:
                return ensure_built(lowerer)[n]

            return build

        results[name] = Table(schemas[name], make_build(), universe=Universe())
    holder["lowerer_id"] = None  # invalidate trial

    if len(results) == 1:
        return next(iter(results.values()))
    import types

    return types.SimpleNamespace(**results)


def iterate_universe(func: Callable, **kwargs):
    return iterate(func, **kwargs)
