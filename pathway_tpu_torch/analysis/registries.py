"""Registry discipline rules: env knobs, metric names, generated docs.

Forty-plus ``PATHWAY_*`` environment knobs grew over time, many
parsed ad hoc with ``os.environ.get`` at the point of use — invisible to
``docs/``, unverifiable by tests, and divergently defaulted.  These
rules force both namespaces through single declared registries:

* ``env-direct-read`` — a ``PATHWAY_*`` read via ``os.environ`` /
  ``os.getenv`` anywhere outside ``internals/config.py``.  Runtime code
  reads knobs through the typed accessors (``config.env_int`` and
  friends), which parse per the declaration.  Writes (``os.environ[k] =
  v``, ``setdefault``, ``pop``) stay legal everywhere — process
  orchestration composes worker environments by design.
* ``env-undeclared`` — any ``PATHWAY_*`` name used anywhere (read,
  write, accessor call, ``ENV_*`` constant, env-dict kwarg) that is not
  declared in ``internals/config.py:ENV_KNOBS``.
* ``metric-undeclared`` / ``metric-nonliteral`` — every dotted metric
  name registered on the unified registry (``engine/metrics.py``) must
  be a literal declared in ``engine/metrics.py:METRICS`` with a matching
  kind; a name the checker cannot resolve statically is itself flagged.
* ``env-docs-stale`` — ``docs/torch_configuration.md`` must equal
  ``config.render_env_docs()`` exactly; the doc is generated
  (``python -m pathway_tpu_torch lint --update-config-docs``), never hand-edited.

Env rules run over package files only: tests manipulate environments
through monkeypatch fixtures, which write — writes are fine.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from pathway_tpu_torch.analysis.callgraph import FuncInfo, Index, get_index
from pathway_tpu_torch.analysis.core import Finding, Project, Rule, SourceFile

_ENV_NAME_RE = re.compile(r"^PATHWAY_[A-Z0-9_]+$")
_ACCESSORS = {"env_raw", "env_str", "env_bool", "env_int", "env_float"}
_ENV_WRITE_ATTRS = {"setdefault", "pop", "update"}
_CONFIG_MODULE = "pathway_tpu_torch.internals.config"


def _env_registry() -> dict:
    from pathway_tpu_torch.internals.config import ENV_REGISTRY

    return ENV_REGISTRY


def _metric_registry() -> dict:
    from pathway_tpu_torch.engine.metrics import METRICS

    return METRICS


def _is_os_environ(expr: ast.AST, mod) -> bool:
    """True for ``os.environ`` (through any alias of ``os``) or a bare
    ``environ`` imported from ``os``."""
    if isinstance(expr, ast.Attribute) and expr.attr == "environ":
        if isinstance(expr.value, ast.Name):
            return mod.imports.get(expr.value.id) == "os"
    if isinstance(expr, ast.Name):
        return mod.from_imports.get(expr.id) == ("os", "environ")
    return False


def _resolve_name_arg(
    index: Index, file: SourceFile, expr: ast.AST
) -> str | None:
    """A string the expression statically evaluates to, if any."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.Name):
        mod = index.modules.get(_module_key(index, file))
        if mod is None:
            return None
        if expr.id in mod.constants:
            return mod.constants[expr.id]
        imp = mod.from_imports.get(expr.id)
        if imp is not None:
            other = index.modules.get(imp[0])
            if other is not None:
                return other.constants.get(imp[1])
    return None


def _module_key(index: Index, file: SourceFile) -> str:
    from pathway_tpu_torch.analysis.callgraph import module_name_of

    name = module_name_of(file)
    return name if name in index.modules else file.display_path


def check_env_registry(project: Project) -> Iterable[Finding]:
    index = get_index(project)
    registry = _env_registry()
    for file in project.package_files:
        mod = index.modules.get(_module_key(index, file))
        if mod is None:
            continue
        is_config = file.display_path.replace(os.sep, "/").endswith(
            "internals/config.py"
        )
        for node in ast.walk(file.tree):
            for name, lineno, is_read in _env_uses(index, file, mod, node):
                if _ENV_NAME_RE.match(name) and name not in registry:
                    yield Finding(
                        "env-undeclared",
                        file.display_path,
                        lineno,
                        f"{name} is not declared in internals/config.py:"
                        "ENV_KNOBS — declare it (name, type, default, doc) "
                        "so docs/torch_configuration.md stays complete",
                    )
                if is_read and not is_config and _ENV_NAME_RE.match(name):
                    yield Finding(
                        "env-direct-read",
                        file.display_path,
                        lineno,
                        f"direct os.environ read of {name} — go through "
                        "the typed registry accessor "
                        "(pathway_tpu_torch.internals.config.env_*)",
                    )


def _env_uses(
    index: Index, file: SourceFile, mod, node: ast.AST
) -> Iterable[tuple[str, int, bool]]:
    """(name, line, is_read) for every env-name use at ``node``."""
    if isinstance(node, ast.Call):
        fn = node.func
        # os.environ.get(...) / os.environ.pop(...) / os.getenv(...)
        if isinstance(fn, ast.Attribute) and _is_os_environ(fn.value, mod):
            name = (
                _resolve_name_arg(index, file, node.args[0])
                if node.args
                else None
            )
            if name is not None:
                yield name, node.lineno, fn.attr == "get"
            return
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and mod.imports.get(fn.value.id) == "os"
            and fn.attr == "getenv"
        ) or (
            isinstance(fn, ast.Name)
            and mod.from_imports.get(fn.id) == ("os", "getenv")
        ):
            name = (
                _resolve_name_arg(index, file, node.args[0])
                if node.args
                else None
            )
            if name is not None:
                yield name, node.lineno, True
            return
        # typed accessor calls: declaration check only (the blessed path)
        accessor = None
        if isinstance(fn, ast.Name) and fn.id in _ACCESSORS:
            imp = mod.from_imports.get(fn.id)
            if imp is not None and imp[0] == _CONFIG_MODULE:
                accessor = fn.id
        elif isinstance(fn, ast.Attribute) and fn.attr in _ACCESSORS:
            accessor = fn.attr
        if accessor is not None and node.args:
            name = _resolve_name_arg(index, file, node.args[0])
            if name is not None:
                yield name, node.lineno, False
            return
        # env-dict composition kwargs: env.update(PATHWAY_THREADS=...)
        for kw in node.keywords:
            if kw.arg and _ENV_NAME_RE.match(kw.arg):
                yield kw.arg, node.lineno, False
        return
    if isinstance(node, ast.Subscript):
        name = _resolve_name_arg(index, file, node.slice)
        if name is None or not _ENV_NAME_RE.match(name):
            return
        if _is_os_environ(node.value, mod):
            yield name, node.lineno, isinstance(node.ctx, ast.Load)
        else:
            # env["PATHWAY_X"] on a composed worker environment: a write,
            # but the name must still be declared
            yield name, node.lineno, False
        return
    if isinstance(node, ast.Compare) and any(
        _is_os_environ(c, mod) for c in node.comparators
    ):
        name = _resolve_name_arg(index, file, node.left)
        if name is not None:
            yield name, node.lineno, True
        return
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
        value = node.value.value
        if isinstance(value, str) and _ENV_NAME_RE.match(value):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    yield value, node.lineno, False


_METRIC_METHODS = {"counter", "gauge", "histogram"}


def check_metric_registry(project: Project) -> Iterable[Finding]:
    index = get_index(project)
    metrics = _metric_registry()
    for file in project.package_files:
        display = file.display_path.replace(os.sep, "/")
        if display.endswith("engine/metrics.py"):
            continue  # the registry implementation itself
        for node in ast.walk(file.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in _METRIC_METHODS and node.args:
                name = _resolve_name_arg(index, file, node.args[0])
                if name is None:
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant):
                        continue  # non-string literal: not a metric call
                    yield Finding(
                        "metric-nonliteral",
                        file.display_path,
                        node.lineno,
                        f".{attr}() with a name the checker cannot resolve "
                        "statically — use a literal (or module constant) "
                        "declared in engine/metrics.py:METRICS",
                    )
                    continue
                if "." not in name:
                    continue  # not a dotted metric name (dict.gauge etc.)
                declared = metrics.get(name)
                if declared is None:
                    yield Finding(
                        "metric-undeclared",
                        file.display_path,
                        node.lineno,
                        f"metric {name!r} is not declared in "
                        "engine/metrics.py:METRICS",
                    )
                elif declared[0] != attr:
                    yield Finding(
                        "metric-undeclared",
                        file.display_path,
                        node.lineno,
                        f"metric {name!r} is declared as a "
                        f"{declared[0]}, registered here as a {attr}",
                    )
            elif attr == "register_collector" and node.args:
                name = _resolve_name_arg(index, file, node.args[0])
                if name is None:
                    continue
                declared = metrics.get(name)
                if declared is None or declared[0] != "collector":
                    yield Finding(
                        "metric-undeclared",
                        file.display_path,
                        node.lineno,
                        f"collector {name!r} is not declared (as kind "
                        "'collector') in engine/metrics.py:METRICS",
                    )


def check_env_docs(project: Project) -> Iterable[Finding]:
    config_file = None
    for f in project.package_files:
        if f.display_path.replace(os.sep, "/").endswith("internals/config.py"):
            config_file = f
            break
    if config_file is None:
        return  # corpus / partial-tree lint: nothing to sync
    root = os.path.realpath(config_file.path)
    while os.path.basename(root) != "pathway_tpu_torch" and root != os.path.dirname(root):
        root = os.path.dirname(root)
    doc_path = os.path.join(os.path.dirname(root), "docs", "torch_configuration.md")
    from pathway_tpu_torch.internals.config import render_env_docs

    expected = render_env_docs()
    try:
        with open(doc_path, encoding="utf-8") as f:
            actual = f.read()
    except OSError:
        yield Finding(
            "env-docs-stale",
            doc_path,
            1,
            "docs/torch_configuration.md is missing — run "
            "`python -m pathway_tpu_torch lint --update-config-docs`",
        )
        return
    if actual != expected:
        yield Finding(
            "env-docs-stale",
            doc_path,
            1,
            "docs/torch_configuration.md does not match the env registry — run "
            "`python -m pathway_tpu_torch lint --update-config-docs` (the file is "
            "generated, never hand-edited)",
        )


def _cached(attr: str, check):
    """One shared pass serves the rules it emits for; each rule filters
    by its own id, so subset runs (``--rules env-undeclared``) see the
    same findings a full run would."""

    def filtered(rule_id: str):
        def run(project: Project) -> Iterable[Finding]:
            findings = getattr(project, attr, None)
            if findings is None:
                findings = list(check(project))
                setattr(project, attr, findings)
            return [f for f in findings if f.rule == rule_id]

        return run

    return filtered


_env_rule = _cached("_env_registry_findings", check_env_registry)
_metric_rule = _cached("_metric_registry_findings", check_metric_registry)

RULES = [
    Rule(
        "env-direct-read",
        "PATHWAY_* env var read via os.environ outside the typed registry "
        "accessors in internals/config.py",
        _env_rule("env-direct-read"),
    ),
    Rule(
        "env-undeclared",
        "PATHWAY_* name not declared in internals/config.py:ENV_KNOBS",
        _env_rule("env-undeclared"),
    ),
    Rule(
        "metric-undeclared",
        "dotted metric name not declared (with matching kind) in "
        "engine/metrics.py:METRICS",
        _metric_rule("metric-undeclared"),
    ),
    Rule(
        "metric-nonliteral",
        "metric registered under a name the checker cannot resolve "
        "statically",
        _metric_rule("metric-nonliteral"),
    ),
    Rule(
        "env-docs-stale",
        "docs/torch_configuration.md out of sync with the env registry",
        check_env_docs,
    ),
]
