"""JIT recompile discipline: the static half of "recompile-count == 0".

The ROADMAP's DeviceExecutor arc pins steady-state recompiles at zero
with a runtime cache-miss counter; these rules catch the call-site
shapes that *guarantee* recompiles before the code ever runs:

* ``jit-immediate-call`` — ``jax.jit(f)(x)``: a fresh wrapper (and a
  fresh compile cache) per execution.  The wrapper must be built once
  and reused.
* ``jit-in-loop`` — ``jax.jit(...)`` / ``pjit(...)`` lexically inside a
  ``for``/``while`` body: one new wrapper per iteration.
* ``jit-uncached-wrap`` — a ``jax.jit(...)`` expression inside a
  function body whose result is not observably cached: accepted sinks
  are an assignment to ``self.<attr>`` (per-instance cache), a local
  that is later stored into a ``self`` attribute or subscript (the
  memo-dict bucketing idiom of ``models/decoder.py:_chunk_fn``),
  returned, or yielded.  Decorator usage (``@jax.jit``,
  ``@functools.partial(jax.jit, ...)``) and module/class-level wraps are
  always fine — they run once per definition.
* ``jit-nonhashable-static`` — a ``static_argnums``/``static_argnames``
  jit whose call site passes a list/dict/set literal in a static slot:
  every call re-hash-fails into a recompile (and on older jax, a
  ``TypeError``).

* ``jit-outside-executor`` — any ``jax.jit``/``pjit`` construction in
  ``xpacks/`` or ``stdlib/``: since the DeviceExecutor landed
  (``pathway_tpu_torch/device/``) it is the ONE sanctioned jit entry point for
  model/index code — it owns batch bucketing, the explicit compile-cache
  keys, warmup, and the dispatch metrics.  A direct jit there compiles
  outside that discipline: no bucket policy, no ``device.cache.cold``
  accounting, invisible to ``warmup()``.  Register the callable instead
  (``executor.register(...)`` + ``run_batch``).  Suppressible like every
  rule when a site genuinely cannot route through the executor.

Shape-*value* variance (ragged batches hitting a jitted function) is
invisible to static analysis — that half of the pin stays with the
runtime counter; the bucketing helper these rules push call sites
toward is what makes the runtime pin reachable.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from pathway_tpu_torch.analysis.core import Finding, Project, Rule, SourceFile

_JIT_NAMES = {"jit", "pjit"}


def _is_jit_callable(expr: ast.AST) -> bool:
    """``jax.jit`` / ``pjit`` / ``functools.partial(jax.jit, ...)``."""
    if isinstance(expr, ast.Attribute) and expr.attr in _JIT_NAMES:
        return True
    if isinstance(expr, ast.Name) and expr.id in _JIT_NAMES:
        return True
    if isinstance(expr, ast.Call):  # functools.partial(jax.jit, ...)
        fn = expr.func
        partial = (
            isinstance(fn, ast.Attribute) and fn.attr == "partial"
        ) or (isinstance(fn, ast.Name) and fn.id == "partial")
        if partial and expr.args and _is_jit_callable(expr.args[0]):
            return True
    return False


def _is_jit_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _is_jit_callable(node.func)


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    out: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _static_kw(call: ast.Call) -> bool:
    return any(
        k.arg in ("static_argnums", "static_argnames") for k in call.keywords
    )


def _local_cached(func: ast.AST, var: str) -> bool:
    """True when local ``var`` is later stored into a self attribute /
    subscript, returned, or yielded inside ``func``."""
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            if not (
                isinstance(node.value, ast.Name) and node.value.id == var
            ):
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    return True
                if isinstance(t, ast.Subscript):
                    return True
        elif isinstance(node, (ast.Return, ast.Yield)):
            v = node.value
            if isinstance(v, ast.Name) and v.id == var:
                return True
            if isinstance(v, (ast.Tuple, ast.List)):
                if any(
                    isinstance(e, ast.Name) and e.id == var for e in v.elts
                ):
                    return True
    return False


def _check_file(file: SourceFile) -> Iterable[Finding]:
    parents = _parents(file.tree)
    for node in ast.walk(file.tree):
        if not _is_jit_call(node):
            continue
        # decorator position is always fine (runs once per definition)
        parent = parents.get(node)
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node in parent.decorator_list
        ):
            continue
        if isinstance(parent, ast.Call) and node in (
            parent.args
        ):  # partial(jax.jit, ...) handled at the partial call itself
            if _is_jit_callable(parent):
                continue
        # jax.jit(f)(x): the wrapper dies with the expression
        if isinstance(parent, ast.Call) and parent.func is node:
            yield Finding(
                "jit-immediate-call",
                file.display_path,
                node.lineno,
                "jax.jit(...)(...) builds a fresh compiled wrapper per "
                "call — bind the wrapper once and reuse it",
            )
            continue
        # climb to classify the enclosing scope
        enclosing_fn = None
        in_loop = False
        cursor = parent
        while cursor is not None:
            if isinstance(cursor, (ast.For, ast.While)) and enclosing_fn is None:
                in_loop = True
            if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
                enclosing_fn = cursor
                break
            cursor = parents.get(cursor)
        if in_loop:
            yield Finding(
                "jit-in-loop",
                file.display_path,
                node.lineno,
                "jax.jit(...) inside a loop body compiles a new wrapper "
                "per iteration — hoist it (or memoize per bucket key)",
            )
            continue
        if enclosing_fn is None:
            continue  # module/class level: built once at import
        # inside a function: the result must land somewhere durable
        sink_ok = False
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    sink_ok = True  # self._apply = jax.jit(...) and friends
                elif isinstance(t, ast.Name) and _local_cached(
                    enclosing_fn, t.id
                ):
                    sink_ok = True
        elif isinstance(parent, (ast.Return, ast.Yield)):
            sink_ok = True  # factory pattern: caller owns the cache
        if not sink_ok:
            yield Finding(
                "jit-uncached-wrap",
                file.display_path,
                node.lineno,
                "jax.jit(...) built inside a function but never cached "
                "(not stored on self, not returned) — every call of the "
                "enclosing function recompiles",
            )


def _check_nonhashable_static(file: SourceFile) -> Iterable[Finding]:
    """jit wrappers with static args called with container literals.

    Detects the one-function window: ``f = jax.jit(g, static_argnums=
    (1,)); f(x, [a, b])`` — the list in a static slot re-hashes (and
    fails) every call."""
    for fn_node in ast.walk(file.tree):
        if not isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            continue
        static_wrappers: dict[str, tuple[int, ...] | None] = {}
        body = getattr(fn_node, "body", [])
        for node in body:
            if (
                isinstance(node, ast.Assign)
                and _is_jit_call(node.value)
                and _static_kw(node.value)
            ):
                argnums: tuple[int, ...] | None = None
                for k in node.value.keywords:
                    if k.arg == "static_argnums" and isinstance(
                        k.value, (ast.Tuple, ast.Constant)
                    ):
                        if isinstance(k.value, ast.Constant) and isinstance(
                            k.value.value, int
                        ):
                            argnums = (k.value.value,)
                        elif isinstance(k.value, ast.Tuple):
                            vals = [
                                e.value
                                for e in k.value.elts
                                if isinstance(e, ast.Constant)
                                and isinstance(e.value, int)
                            ]
                            argnums = tuple(vals)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        static_wrappers[t.id] = argnums
        if not static_wrappers:
            continue
        for node in ast.walk(fn_node):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in static_wrappers
            ):
                continue
            argnums = static_wrappers[node.func.id]
            positions = (
                argnums
                if argnums is not None
                else tuple(range(len(node.args)))
            )
            for pos in positions:
                if pos < len(node.args) and isinstance(
                    node.args[pos], (ast.List, ast.Dict, ast.Set)
                ):
                    yield Finding(
                        "jit-nonhashable-static",
                        file.display_path,
                        node.lineno,
                        f"argument {pos} of {node.func.id}() is declared "
                        "static but receives a non-hashable container "
                        "literal — every call misses the jit cache",
                    )


# path segments whose files must route jit through the DeviceExecutor
_EXECUTOR_GUARDED_SEGMENTS = {"xpacks", "stdlib"}


def _check_outside_executor(file: SourceFile) -> Iterable[Finding]:
    """Every jit construction in an executor-guarded tree is a finding —
    decorator or not: the objection is to the compile cache existing
    outside the executor's discipline, not to any one call shape."""
    parts = set(file.display_path.replace(os.sep, "/").split("/"))
    if not (parts & _EXECUTOR_GUARDED_SEGMENTS):
        return
    flagged: list[ast.AST] = []
    for node in ast.walk(file.tree):
        if isinstance(node, ast.Call) and (
            _is_jit_call(node) or _is_jit_callable(node)
        ):
            flagged.append(node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # bare `@jax.jit` decorators are Attribute nodes, not Calls
            flagged.extend(
                d
                for d in node.decorator_list
                if not isinstance(d, ast.Call) and _is_jit_callable(d)
            )
    seen_lines: set[int] = set()
    for node in flagged:
        if node.lineno in seen_lines:
            continue
        seen_lines.add(node.lineno)
        yield Finding(
            "jit-outside-executor",
            file.display_path,
            node.lineno,
            "direct jax.jit in an xpacks/stdlib module — the "
            "DeviceExecutor (pathway_tpu_torch/device/) is the sanctioned jit "
            "entry point: register the callable and dispatch via "
            "run_batch so bucketing, cache-key accounting and warmup "
            "apply",
        )


def _cached_jit_findings(project: Project) -> list[Finding]:
    """One walk (and one parent-map build) per file serves all five
    rules — they filter by id from this shared pass."""
    cached = getattr(project, "_jit_findings", None)
    if cached is None:
        cached = []
        for file in project.package_files:
            cached.extend(_check_file(file))
            cached.extend(_check_nonhashable_static(file))
            cached.extend(_check_outside_executor(file))
        project._jit_findings = cached  # type: ignore[attr-defined]
    return cached


def _run(rule_id: str):
    def check(project: Project) -> Iterable[Finding]:
        return [f for f in _cached_jit_findings(project) if f.rule == rule_id]

    return check


RULES = [
    Rule(
        "jit-immediate-call",
        "jax.jit(f)(x): fresh compiled wrapper (and compile) per call",
        _run("jit-immediate-call"),
    ),
    Rule(
        "jit-in-loop",
        "jax.jit/pjit constructed inside a loop body",
        _run("jit-in-loop"),
    ),
    Rule(
        "jit-uncached-wrap",
        "jax.jit built inside a function without a durable cache sink",
        _run("jit-uncached-wrap"),
    ),
    Rule(
        "jit-nonhashable-static",
        "container literal passed in a static_argnums/static_argnames slot",
        _run("jit-nonhashable-static"),
    ),
    Rule(
        "jit-outside-executor",
        "jax.jit in xpacks/stdlib outside the DeviceExecutor entry point",
        _run("jit-outside-executor"),
    ),
]
