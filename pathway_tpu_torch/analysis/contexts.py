"""Thread-context safety rules.

The runtime's thread entry points are annotated in source with
``# pathway-lint: context=<name>`` on (or directly above) the ``def``
line; :meth:`Index.propagate_contexts` spreads each context through the
static call graph.  Every context carries a policy:

==============  =============  ==================================================
context         policy         meaning
==============  =============  ==================================================
``epoch``       ``no-block``   the epoch loop: never sleep, never wait without a
                               timeout, no sockets / subprocesses / HTTP — a
                               blocked epoch thread stalls every input and trips
                               the supervisor's watchdog
``signal``      ``signal``     SIGUSR1 flight-recorder path: on top of the
                               no-block set, only provably REENTRANT locks — the
                               handler interrupts the main thread mid-anything,
                               and a plain ``threading.Lock`` held by the
                               interrupted frame deadlocks the worker
``committer``   ``bounded``    persistence committer thread
``writer``      ``bounded``    checkpoint writer pool
``watchdog``    ``bounded``    supervisor progress watchdog
``telemetry``   ``bounded``    telemetry sampler + export-queue drain
``heartbeat``   ``bounded``    comm-mesh heartbeat loop
``device``      ``bounded``    DeviceExecutor dispatch thread
==============  =============  ==================================================

``bounded`` contexts may sleep and do I/O — that is their job — but
every lock/condition/join wait must carry a timeout: an untimed wait in
a supervised background thread is exactly the silent-hang class the
supervisor's watchdog exists for, and the watchdog cannot see threads that are not
the epoch loop.

Rule ids: ``ctx-blocking-call`` (no-block violations), ``ctx-untimed-wait``
(bounded violations, also emitted for no-block/signal contexts),
``signal-unsafe-lock`` (non-reentrant lock reachable from a signal
handler).
"""

from __future__ import annotations

import ast
from typing import Iterable

from pathway_tpu_torch.analysis.callgraph import FuncInfo, Index, get_index
from pathway_tpu_torch.analysis.core import Finding, Project, Rule

POLICIES = {
    "epoch": "no-block",
    "signal": "signal",
    "committer": "bounded",
    "writer": "bounded",
    "watchdog": "bounded",
    "telemetry": "bounded",
    "heartbeat": "bounded",
    "device": "bounded",
}

_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "getoutput"}
_SOCKET_ATTRS = {"accept", "recv", "recvfrom", "recv_into", "sendall", "connect"}


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in call.keywords)


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_module_call(
    index: Index, func: FuncInfo, call: ast.Call, module: str, names: set[str]
) -> bool:
    """True when ``call`` is ``<alias-of-module>.<name>(...)``."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in names):
        return False
    recv = fn.value
    mod = index.module_of(func)
    local_imports, local_from = index._local_imports(func)
    if isinstance(recv, ast.Name):
        target = local_imports.get(recv.id) or mod.imports.get(recv.id)
        return target == module
    if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name):
        # urllib.request.urlopen
        base = local_imports.get(recv.value.id) or mod.imports.get(recv.value.id)
        return f"{base}.{recv.attr}" == module if base else False
    return False


def _untimed_wait_reason(call: ast.Call) -> str | None:
    """Reason string when ``call`` is a wait that can block forever."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    if attr == "wait":
        timeout = call.args[0] if call.args else _kw(call, "timeout")
        if timeout is None or (
            isinstance(timeout, ast.Constant) and timeout.value is None
        ):
            return ".wait() without a timeout"
        return None
    if attr == "wait_for":
        if len(call.args) < 2 and not _has_kw(call, "timeout"):
            return ".wait_for() without a timeout"
        return None
    if attr == "acquire":
        blocking = call.args[0] if call.args else _kw(call, "blocking")
        if isinstance(blocking, ast.Constant) and blocking.value is False:
            return None  # non-blocking try-acquire
        if len(call.args) >= 2 or _has_kw(call, "timeout"):
            return None
        return ".acquire() without a timeout"
    if attr == "join" and not call.args and not call.keywords:
        return ".join() without a timeout"
    if attr == "result" and not call.args and not _has_kw(call, "timeout"):
        return ".result() without a timeout"
    if attr == "get":
        # queue-style blocking get: an explicit block=True (or positional
        # True) with no timeout.  Bare ``.get()`` is NOT flagged — it is
        # overwhelmingly dict/ContextVar access, which never blocks.
        block = call.args[0] if call.args else _kw(call, "block")
        if (
            isinstance(block, ast.Constant)
            and block.value is True
            and len(call.args) < 2
            and not _has_kw(call, "timeout")
        ):
            return ".get(block=True) without a timeout"
    return None


def _blocking_reason(index: Index, func: FuncInfo, call: ast.Call) -> str | None:
    """Reason when ``call`` blocks at all (the no-block superset)."""
    if _is_module_call(index, func, call, "time", {"sleep"}):
        return "time.sleep()"
    fn = call.func
    if isinstance(fn, ast.Name):
        mod = index.module_of(func)
        imp = mod.from_imports.get(fn.id)
        if imp == ("time", "sleep"):
            return "time.sleep()"
        if fn.id == "input":
            return "input()"
    if _is_module_call(index, func, call, "subprocess", _SUBPROCESS_FNS):
        return f"subprocess.{call.func.attr}()"  # type: ignore[union-attr]
    if _is_module_call(index, func, call, "urllib.request", {"urlopen"}):
        return "urllib.request.urlopen()"
    if _is_module_call(index, func, call, "os", {"system"}):
        return "os.system()"
    if _is_module_call(index, func, call, "select", {"select"}):
        if len(call.args) < 4:
            return "select.select() without a timeout"
        return None
    if isinstance(fn, ast.Attribute) and fn.attr in _SOCKET_ATTRS:
        if fn.attr == "connect" and isinstance(fn.value, ast.Name):
            # sqlite3.connect / psycopg.connect are module functions —
            # still blocking I/O, still flagged; but only flag communicate
            # and friends on plain receivers to keep this decidable
            pass
        return f"socket-style .{fn.attr}()"
    if isinstance(fn, ast.Attribute) and fn.attr == "communicate":
        if not _has_kw(call, "timeout"):
            return ".communicate() without a timeout"
    return _untimed_wait_reason(call)


def _signal_lock_findings(
    index: Index, func: FuncInfo, contexts: dict[str, str]
) -> Iterable[Finding]:
    """Non-reentrant locks acquired in signal-handler-reachable code."""
    chain = contexts["signal"]
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
            if resolved is None:
                continue
            symbol, kind = resolved
            if kind in ("lock", "condition-lock", "semaphore"):
                yield Finding(
                    "signal-unsafe-lock",
                    func.file.display_path,
                    lineno,
                    f"{symbol} is a non-reentrant {kind} acquired on a "
                    f"signal-handler path ({chain}); the handler interrupts "
                    "the main thread, which may already hold it — use an "
                    "RLock or move the work off the handler",
                )


def check_thread_contexts(project: Project) -> Iterable[Finding]:
    index = get_index(project)
    contexts = index.propagate_contexts()
    for qname in sorted(contexts):
        func = index.functions.get(qname)
        if func is None:
            continue
        ctx_map = contexts[qname]
        policies: dict[str, tuple[str, str]] = {}
        for ctx in sorted(ctx_map):
            policy = POLICIES.get(ctx)
            if policy is not None:
                policies[policy] = (ctx, ctx_map[ctx])
        if not policies:
            continue
        if "signal" in policies:
            yield from _signal_lock_findings(
                index, func, {"signal": policies["signal"][1]}
            )
        for node in index._own_nodes(func):
            if not isinstance(node, ast.Call):
                continue
            if "no-block" in policies or "signal" in policies:
                policy = "no-block" if "no-block" in policies else "signal"
                ctx, chain = policies[policy]
                reason = _blocking_reason(index, func, node)
                if reason is not None:
                    yield Finding(
                        "ctx-blocking-call",
                        func.file.display_path,
                        node.lineno,
                        f"{reason} on the no-block `{ctx}` context "
                        f"(via {chain})",
                    )
                    continue
            if "bounded" in policies and "no-block" not in policies and "signal" not in policies:
                ctx, chain = policies["bounded"]
                reason = _untimed_wait_reason(node)
                if reason is not None:
                    yield Finding(
                        "ctx-untimed-wait",
                        func.file.display_path,
                        node.lineno,
                        f"{reason} on the supervised `{ctx}` background "
                        f"context (via {chain}) — an untimed wait here is a "
                        "silent hang the watchdog cannot see",
                    )


def _cached_context_findings(project: Project) -> list[Finding]:
    """One propagation pass serves all three context rules."""
    cached = getattr(project, "_context_findings", None)
    if cached is None:
        cached = list(check_thread_contexts(project))
        project._context_findings = cached  # type: ignore[attr-defined]
    return cached


def _only(rule_id: str):
    def check(project: Project) -> Iterable[Finding]:
        return [f for f in _cached_context_findings(project) if f.rule == rule_id]

    return check


RULES = [
    Rule(
        "ctx-blocking-call",
        "blocking call (sleep, untimed wait, socket/subprocess/HTTP) "
        "reachable from a no-block context (epoch loop, signal handler)",
        _only("ctx-blocking-call"),
    ),
    Rule(
        "ctx-untimed-wait",
        "lock/condition/join wait without a timeout on a supervised "
        "background thread (committer, writer pool, watchdog, telemetry, "
        "heartbeat)",
        _only("ctx-untimed-wait"),
    ),
    Rule(
        "signal-unsafe-lock",
        "non-reentrant lock acquired on a signal-handler path (the "
        "FlightRecorder-RLock class of deadlock)",
        _only("signal-unsafe-lock"),
    ),
]
