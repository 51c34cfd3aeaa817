"""Lazy build graph.

Parity target: ``python/pathway/internals/parse_graph.py``
(255 LoC).  User Table operations register *recipes*; nothing executes until
``pw.run()`` / ``pw.debug.compute_and_print``.  The global graph ``G`` tracks
sinks (output/subscribe operators) and all created tables so the runner can
tree-shake and execute, and so tests can ``G.clear()`` between cases.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable


class ParseGraph:
    def __init__(self):
        self.clear()

    def clear(self) -> None:
        # sinks: list of (name, table, attach) where attach(lowerer, node) -> poller list
        self.sinks: list[tuple[str, Any, Callable]] = []
        self.tables: list[Any] = []
        self._id_counter = itertools.count()
        self.error_log_stack: list[Any] = []

    # mirrors G.clear() used throughout reference tests
    def new_table(self, table: Any) -> None:
        self.tables.append(table)

    def add_sink(self, name: str, table: Any, attach: Callable) -> None:
        self.sinks.append((name, table, attach))

    def next_id(self) -> int:
        return next(self._id_counter)


G = ParseGraph()
