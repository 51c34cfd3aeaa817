"""``chaos-bounded-sleep``: the chaos suite must not synchronize on sleep.

The chaos-suite lint (``tests/test_chaos_lint.py`` runs it as a thin
wrapper over this rule).  The supervised-recovery and fault-injection tests
pin interleavings that genuinely matter; on the noisy shared-tenant rig,
"sleep long enough and hope" synchronization turns them into flakes —
the repo convention is to GATE on on-disk state (the ``_gated_scenario``
pattern).  Exact behavior preserved from the original:

* a ``*.sleep(...)`` call is rejected unless it is a **poll step inside
  a ``while`` loop** (the loop condition decides, not the sleep),
* or a **pacing sleep** with a constant (or module-constant) argument
  ≤ 0.05 s,
* or annotated ``# chaos-lint: bounded-window`` on the call line or the
  two lines above — a deliberate, documented observation window.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from pathway_tpu_torch.analysis.core import Finding, Project, Rule, SourceFile

CHAOS_FILES = (
    "test_supervised_recovery.py",
    "test_fault_injection.py",
    "test_checkpoint_integrity.py",
    "test_observability.py",
    "test_fencing_watchdog.py",
    "test_device_executor.py",
)

PACING_MAX_S = 0.05
MARKER = "chaos-lint: bounded-window"


def _module_constants(tree: ast.Module) -> dict[str, float]:
    """Module-level numeric assignments (ROW_DELAY_S = 0.03 and friends)."""
    out: dict[str, float] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            value = node.value.value
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        out[target.id] = float(value)
    return out


def _sleep_calls(tree: ast.Module):
    """Yield (call node, inside_while) for every ``<x>.sleep(...)``."""
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "sleep"
        ):
            continue
        inside_while = False
        cursor: ast.AST | None = node
        while cursor is not None:
            cursor = parents.get(cursor)
            if isinstance(cursor, ast.While):
                inside_while = True
                break
            if isinstance(
                cursor, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)
            ):
                # a while loop in an ENCLOSING function does not make this
                # sleep a poll step of it
                break
        yield node, inside_while


def _constant_arg(call: ast.Call, constants: dict[str, float]) -> float | None:
    if len(call.args) != 1:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, (int, float)):
        return float(arg.value)
    if isinstance(arg, ast.Name):
        return constants.get(arg.id)
    return None


def check_file(file: SourceFile) -> Iterable[Finding]:
    """The rule body for one chaos test file (also the wrapper's entry)."""
    constants = _module_constants(file.tree)
    for call, inside_while in _sleep_calls(file.tree):
        if inside_while:
            continue  # gated poll step: the loop condition decides
        value = _constant_arg(call, constants)
        if value is not None and value <= PACING_MAX_S:
            continue  # row pacing, too short to hide a wait
        window = file.lines[max(0, call.lineno - 3): call.lineno]
        if any(MARKER in line for line in window):
            continue  # documented bounded observation window
        arg = ast.unparse(call.args[0]) if call.args else ""
        yield Finding(
            "chaos-bounded-sleep",
            file.display_path,
            call.lineno,
            f"bare sleep({arg}) — gate on on-disk state (while-loop poll) "
            f"instead, or pace with a constant <= {PACING_MAX_S}s, or "
            f"annotate `# {MARKER}`",
        )


def check_chaos_sleeps(project: Project) -> Iterable[Finding]:
    for file in project.files:
        if os.path.basename(file.display_path) in CHAOS_FILES:
            yield from check_file(file)


RULES = [
    Rule(
        "chaos-bounded-sleep",
        "time.sleep-based synchronization in the chaos test suite "
        "(poll in a while loop, pace <= 0.05s, or annotate "
        "`# chaos-lint: bounded-window`)",
        check_chaos_sleeps,
    ),
]
