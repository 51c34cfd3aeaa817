"""Static lock-order checker.

Extracts the lock-acquisition ORDER the code implies — ``with A: ...
with B:`` nests A before B, and a call made while holding A to a
function that may acquire B implies A before B transitively — and fails
on inversions: a cycle in the order graph is a deadlock waiting for the
right interleaving.

Lock identity is by (class, attribute) or (module, global): instances
conflate deliberately, which is exactly the discipline a lock hierarchy
asks of humans ("never take ``send_lock`` while holding ``cv``",
``engine/comm.py``'s ``_Link`` docstring).  Self-edges on non-reentrant
locks are reported too — ``with self._lock`` nested inside itself is a
self-deadlock, not an ordering question.

Rule id: ``lock-order``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from pathway_tpu_torch.analysis.callgraph import FuncInfo, Index, get_index
from pathway_tpu_torch.analysis.core import Finding, Project, Rule

_ORDERED_KINDS = {
    "lock", "rlock", "condition", "condition-lock", "condition-rlock",
    "semaphore",
}


class _Edge:
    __slots__ = ("holder", "acquired", "path", "line", "via")

    def __init__(self, holder: str, acquired: str, path: str, line: int, via: str):
        self.holder = holder
        self.acquired = acquired
        self.path = path
        self.line = line
        self.via = via


def _direct_acquires(index: Index, func: FuncInfo) -> list[tuple[str, str, int]]:
    out = []
    for node in index._own_nodes(func):
        exprs: list[tuple[ast.AST, int]] = []
        if isinstance(node, ast.With):
            exprs = [(item.context_expr, node.lineno) for item in node.items]
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            exprs = [(node.func.value, node.lineno)]
        for expr, lineno in exprs:
            resolved = index.resolve_lock_expr(func, expr)
            if resolved is not None and resolved[1] in _ORDERED_KINDS:
                out.append((resolved[0], resolved[1], lineno))
    return out


def _may_acquire(index: Index) -> dict[str, set[str]]:
    """Fixpoint: every lock symbol a function may acquire, transitively
    through resolvable calls."""
    direct: dict[str, set[str]] = {}
    callees: dict[str, set[str]] = {}
    for qname, func in index.functions.items():
        direct[qname] = {s for s, _k, _l in _direct_acquires(index, func)}
        callees[qname] = set()
        for call in index._own_calls(func):
            for callee in index.resolve_call(call, func):
                callees[qname].add(callee.qname)
    acq = {q: set(s) for q, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for qname in acq:
            before = len(acq[qname])
            for c in callees[qname]:
                acq[qname] |= acq.get(c, set())
            if len(acq[qname]) != before:
                changed = True
    return acq


def _edges_of(
    index: Index, func: FuncInfo, may_acquire: dict[str, set[str]]
) -> Iterable[_Edge]:
    """Walk ``func`` maintaining the held-lock stack; emit order edges."""
    kinds: dict[str, str] = {}

    def visit(node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        new_held = held
        if isinstance(node, ast.With):
            acquired_here: list[str] = []
            for item in node.items:
                resolved = index.resolve_lock_expr(func, item.context_expr)
                if resolved is not None and resolved[1] in _ORDERED_KINDS:
                    sym, kind = resolved
                    kinds[sym] = kind
                    for h in held:
                        edges.append(
                            _Edge(h, sym, func.file.display_path, node.lineno, "")
                        )
                    if sym in held and kind in ("lock", "condition-lock", "semaphore"):
                        edges.append(
                            _Edge(sym, sym, func.file.display_path, node.lineno, "")
                        )
                    acquired_here.append(sym)
            new_held = held + tuple(acquired_here)
        elif isinstance(node, ast.Call) and held:
            for callee in index.resolve_call(node, func):
                for sym in sorted(may_acquire.get(callee.qname, ())):
                    for h in held:
                        if h == sym:
                            continue  # re-acquisition is the signal rule's
                        edges.append(
                            _Edge(
                                h, sym, func.file.display_path, node.lineno,
                                f" (via call to {callee.qname})",
                            )
                        )
        for child in ast.iter_child_nodes(node):
            visit(child, new_held)

    edges: list[_Edge] = []
    for child in ast.iter_child_nodes(func.node):
        visit(child, ())
    return edges


def check_lock_order(project: Project) -> Iterable[Finding]:
    index = get_index(project)
    may_acquire = _may_acquire(index)
    edges: list[_Edge] = []
    for qname in sorted(index.functions):
        func = index.functions[qname]
        if func.file.is_test:
            continue
        edges.extend(_edges_of(index, func, may_acquire))

    # adjacency + cycle detection (every edge inside a strongly-connected
    # component of >1 node, or a self-edge, is part of an inversion)
    adj: dict[str, set[str]] = {}
    for e in edges:
        adj.setdefault(e.holder, set()).add(e.acquired)
        adj.setdefault(e.acquired, set())

    sccs = _tarjan(adj)
    cyclic_nodes = {n for comp in sccs if len(comp) > 1 for n in comp}
    seen: set[tuple[str, str, str, int]] = set()
    for e in sorted(edges, key=lambda e: (e.path, e.line, e.holder, e.acquired)):
        in_cycle = (
            e.holder == e.acquired
            or (e.holder in cyclic_nodes and e.acquired in cyclic_nodes
                and _same_scc(sccs, e.holder, e.acquired))
        )
        if not in_cycle:
            continue
        key = (e.holder, e.acquired, e.path, e.line)
        if key in seen:
            continue
        seen.add(key)
        if e.holder == e.acquired:
            message = (
                f"non-reentrant {e.holder} acquired while already held"
                f"{e.via} — self-deadlock"
            )
        else:
            message = (
                f"lock order inversion: {e.acquired} acquired while holding "
                f"{e.holder}{e.via}, but an opposite ordering exists "
                "elsewhere — pick one global order"
            )
        yield Finding("lock-order", e.path, e.line, message)


def _same_scc(sccs: list[list[str]], a: str, b: str) -> bool:
    for comp in sccs:
        if a in comp:
            return b in comp
    return False


def _tarjan(adj: dict[str, set[str]]) -> list[list[str]]:
    """Iterative Tarjan SCC (the lint must not recurse past its limits)."""
    index_of: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    for root in sorted(adj):
        if root in index_of:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index_of:
                    index_of[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index_of[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index_of[node]:
                comp = []
                while True:
                    top = stack.pop()
                    on_stack.discard(top)
                    comp.append(top)
                    if top == node:
                        break
                sccs.append(sorted(comp))
    return sccs


RULES = [
    Rule(
        "lock-order",
        "lock-acquisition ordering inversion (or non-reentrant "
        "self-acquisition) across the static call graph",
        check_lock_order,
    ),
]
