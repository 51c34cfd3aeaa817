"""AsyncTransformer (parity: stdlib/utils/async_transformer.py:30-).

Non-blocking async row transformer: results form a *new* stream, decoupled
from input epochs (§3.3 of SURVEY.md).  In this engine the invoke results
re-enter through a dedicated InputNode at later timestamps.
"""

from __future__ import annotations

import asyncio
from typing import Any

from pathway_tpu_torch.engine import dataflow as df
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Lowerer, Table, Universe


class AsyncTransformer:
    r"""Subclass and implement ``async def invoke(self, **kwargs) -> dict``.

    ``output_schema`` must be declared as a class attribute or passed to
    ``__init__``; ``.successful`` gives the result table.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
    >>> class Upper(AsyncTransformer):
    ...     output_schema = pw.schema_from_types(out=str)
    ...     async def invoke(self, w):
    ...         return {"out": w.upper()}
    >>> t = pw.debug.table_from_markdown('w\nhi\nyo')
    >>> res = Upper(input_table=t).successful
    >>> pw.debug.compute_and_print(res, include_id=False)
    out
    HI
    YO
    """

    output_schema: type[schema_mod.Schema] | None = None

    def __init__(self, input_table: Table, *, instance=None, autocommit_duration_ms=1500, name=None):
        self._input_table = input_table
        if self.output_schema is None:
            raise ValueError("AsyncTransformer requires output_schema")
        self._result_table = self._make_result_table()

    def open(self) -> None:  # lifecycle hooks (parity)
        pass

    def close(self) -> None:
        pass

    async def invoke(self, **kwargs) -> dict:
        raise NotImplementedError

    @property
    def successful(self) -> Table:
        return self._result_table

    @property
    def output_table(self) -> Table:
        return self._result_table

    def with_options(self, **kwargs) -> "AsyncTransformer":
        return self

    def _make_result_table(self) -> Table:
        schema = self.output_schema
        names = list(schema.__columns__.keys())
        input_table = self._input_table
        in_names = input_table.column_names()
        transformer = self

        def build(lowerer: Lowerer) -> df.Node:
            in_node = lowerer.node(input_table)
            out_node = df.InputNode(lowerer.scope)
            out_node.finished = False
            pending: list = []

            class _Feeder(df.Node):
                name = "async_transformer_feed"

                def step(self_inner, time):
                    for key, row, diff in self_inner.take_pending():
                        if diff > 0:
                            pending.append((key, row))

            feeder = _Feeder(lowerer.scope, [in_node])

            class _Poller:
                def __init__(self):
                    self.opened = False
                    self.source_done = False

                def poll(self) -> bool:
                    if not self.opened:
                        transformer.open()
                        self.opened = True
                    if pending:
                        batch, pending_clear = list(pending), pending.clear()

                        async def run_batch():
                            coros = []
                            for key, row in batch:
                                kwargs = dict(zip(in_names, row))
                                coros.append(transformer.invoke(**kwargs))
                            return await asyncio.gather(*coros, return_exceptions=True)

                        results = asyncio.run(run_batch())
                        t = lowerer.scope.current_time + 2
                        for (key, row), res in zip(batch, results):
                            if isinstance(res, Exception):
                                continue  # failed rows are dropped (parity: .failed)
                            out_row = tuple(res.get(n) for n in names)
                            out_node.insert(key, out_row, t)
                        return False
                    # finished when the upstream scope has no more input
                    if all(
                        inp.finished
                        for inp in lowerer.scope.nodes
                        if isinstance(inp, df.InputNode) and inp is not out_node
                    ) and not pending:
                        out_node.finished = True
                        transformer.close()
                        return True
                    return False

            lowerer.pollers.append(_Poller())
            return out_node

        return Table(schema, build, universe=Universe())
