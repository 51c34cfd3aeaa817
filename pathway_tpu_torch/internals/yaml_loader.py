"""Declarative app configuration: YAML → constructed pipeline objects.

Parity target: ``python/pathway/internals/yaml_loader.py`` (the loader
behind template ``app.yaml`` files).  Behavior kept:

* ``!pw.io.csv.read`` / ``!mypkg.mod:factory`` tags import the named
  object (``pw`` → ``pathway_tpu_torch``); a mapping node calls it with the
  mapping as kwargs, an empty scalar calls it with no args (or yields the
  object itself if it is not callable).
* ``$name`` scalars are variables.  A mapping key that is a variable
  defines it for that mapping's subtree (lexical scoping); an ALL_CAPS
  variable with no definition falls back to the environment, its value
  parsed as YAML.
* Each definition is constructed at most once and shared by reference;
  unused definitions raise a warning.
"""

from __future__ import annotations

import builtins
import importlib
import os
import re
import functools
import warnings
from typing import Any, Callable

_VAR_TAG = "tag:pathway.com,2024:variable"


class Var:
    """A ``$name`` placeholder awaiting resolution."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return f"${self.name}"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Var) and other.name == self.name

    def __hash__(self) -> int:
        return hash((Var, self.name))


class Thunk:
    """A tagged node: ``factory(**kwargs)`` deferred until resolution."""

    __slots__ = ("factory", "kwargs", "value", "ready")

    def __init__(self, factory: Callable[..., object] | None, kwargs: dict, *, value: object = None, ready: bool = False):
        self.factory = factory
        self.kwargs = kwargs
        self.value = value
        self.ready = ready


def import_object(path: str) -> object:
    """``pkg.mod:attr.sub`` or dotted-only form; ``pw.`` aliases this package."""
    if path.startswith(("pw.", "pw:")):
        path = "pathway_tpu_torch" + path[2:]
    module_path, colon, attr_path = path.partition(":")
    obj: object
    if colon:
        obj = importlib.import_module(module_path) if module_path else builtins
        attrs = attr_path.split(".") if attr_path else []
    else:
        # dotted form: import the longest importable module prefix, then
        # walk the rest as attributes
        names = module_path.split(".")
        obj = builtins
        attrs = names
        for i in range(len(names), 0, -1):
            prefix = ".".join(names[:i])
            try:
                obj = importlib.import_module(prefix)
                attrs = names[i:]
                break
            except ModuleNotFoundError:
                continue
    for attr in attrs:
        obj = getattr(obj, attr)
    return obj


@functools.cache
def _app_loader() -> type:
    """The YAML loader class, built on first use: PyYAML is imported when
    :func:`load_yaml` is called, so the package imports without it."""
    import yaml

    class _AppLoader(yaml.SafeLoader):
        pass

    _AppLoader.add_implicit_resolver(_VAR_TAG, re.compile(r"\$.*"), "$")
    _AppLoader.add_constructor(_VAR_TAG, _construct_var)
    _AppLoader.add_multi_constructor("!", _construct_tagged)
    return _AppLoader


def _construct_var(loader, node) -> Var:
    import yaml

    text = loader.construct_yaml_str(node)
    name = text[1:] if text.startswith("$") else ""
    if not name.isidentifier():
        raise yaml.MarkedYAMLError(
            problem=f"invalid variable name {text!r}",
            problem_mark=node.start_mark,
        )
    return Var(name)


def _construct_tagged(loader, tag: str, node) -> Thunk:
    import yaml

    target = import_object(tag)
    if isinstance(node, yaml.MappingNode):
        if not callable(target):
            raise yaml.MarkedYAMLError(
                problem=f"{tag!r} is not callable", problem_mark=node.start_mark
            )
        kwargs = loader.construct_mapping(node, deep=True)
        for key in kwargs:
            if not isinstance(key, (str, Var)):
                raise yaml.MarkedYAMLError(
                    problem=f"expected string key, got {type(key).__name__}",
                    problem_mark=node.start_mark,
                )
        return Thunk(target, kwargs)
    if isinstance(node, yaml.ScalarNode) and node.value == "":
        if callable(target):
            return Thunk(target, {})
        return Thunk(None, {}, value=target, ready=True)
    raise yaml.MarkedYAMLError(
        problem=f"{tag!r} expects a mapping or an empty node",
        problem_mark=node.start_mark,
    )


class _Scope:
    """Lexically scoped variable bindings; tracks which were ever read."""

    def __init__(self, bindings: dict[Var, object], parent: "_Scope | None" = None):
        self.bindings = bindings
        self.parent = parent
        self.used: set[str] = set()
        # resolved terminal values (shared per load): a resolved object that
        # happens to be a Var/dict/list is data now — never re-interpreted
        self.done: dict[int, object] = parent.done if parent is not None else {}

    def warn_unused(self) -> None:
        for var in self.bindings:
            if var.name not in self.used:
                warnings.warn(f"unused YAML variable ${var.name}", stacklevel=3)


_IN_PROGRESS = object()  # cycle guard for definitions being resolved


def _resolve_var(var: Var, scope: _Scope) -> object:
    # lexical scoping: the definition resolves in the scope where it was
    # defined, not at the use site — `$a: $b` at the root must not pick up
    # an inner subtree's $b
    cursor: _Scope | None = scope
    root = scope
    while cursor is not None:
        if var in cursor.bindings:
            cursor.used.add(var.name)
            value = cursor.bindings[var]
            if value is _IN_PROGRESS:
                raise ValueError(f"circular definition of variable ${var.name}")
            cursor.bindings[var] = _IN_PROGRESS
            try:
                resolved = _resolve(value, cursor)
            finally:
                cursor.bindings[var] = value
            cursor.bindings[var] = resolved  # construct once, share
            cursor.done[id(resolved)] = resolved
            return resolved
        root = cursor
        cursor = cursor.parent
    if var.name == var.name.upper():
        raw = os.environ.get(var.name)
        if raw is not None:
            # cache the env definition at the root so every use shares one
            # constructed object (and self-reference is caught, not a hang)
            root.bindings[var] = _IN_PROGRESS
            try:
                resolved = _resolve(_load(raw), root)
            except BaseException:
                del root.bindings[var]
                raise
            root.bindings[var] = resolved
            root.used.add(var.name)
            root.done[id(resolved)] = resolved
            return resolved
    raise KeyError(f"variable ${var.name} is not defined")


def _split_bindings(mapping: dict) -> tuple[dict[Var, object], dict]:
    bindings = {k: v for k, v in mapping.items() if isinstance(k, Var)}
    rest = {k: v for k, v in mapping.items() if not isinstance(k, Var)}
    return bindings, rest


def _resolve(obj: object, scope: _Scope) -> object:
    if id(obj) in scope.done:
        return obj
    if isinstance(obj, Var):
        return _resolve_var(obj, scope)
    if isinstance(obj, Thunk):
        if not obj.ready:
            # Var keys in a tagged mapping define variables for its kwargs
            bindings, rest = _split_bindings(obj.kwargs)
            inner = _Scope(bindings, parent=scope) if bindings else scope
            kwargs = {k: _resolve(v, inner) for k, v in rest.items()}
            if bindings:
                inner.warn_unused()
            assert obj.factory is not None
            obj.value = obj.factory(**kwargs)
            obj.ready = True  # construct once, share by reference
        return obj.value
    if isinstance(obj, dict):
        bindings, rest = _split_bindings(obj)
        if bindings:
            inner = _Scope(bindings, parent=scope)
            resolved = {k: _resolve(v, inner) for k, v in rest.items()}
            inner.warn_unused()
            return resolved
        return {k: _resolve(v, scope) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v, scope) for v in obj]
    return obj


def _load(stream: Any) -> Any:
    import yaml

    return yaml.load(stream, _app_loader())


def load_yaml(stream: Any) -> Any:
    """Load an app config: tags construct objects, ``$vars`` resolve."""
    return _resolve(_load(stream), _Scope({}))


__all__ = ["load_yaml"]
