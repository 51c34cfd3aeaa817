"""Symbol table + static call graph for the lint rules.

Python resists whole-program call-graph construction; this module does
the *pragmatic* subset the thread-context and lock rules need, resolving
only calls it can prove, never guessing:

* bare names — nested defs, enclosing functions, module functions,
  ``from``-imports of package modules;
* ``module.func(...)`` through import aliases (module-level *and*
  function-level imports — the repo's lazy-import idiom);
* ``self.method(...)`` through the enclosing class and its
  statically-resolvable bases;
* ``obj.method(...)`` where ``obj`` has an inferred type: a local
  assigned from a class constructor, an annotated parameter, or a
  ``self.attr`` assigned a constructor anywhere in the class;
* ``f(...).method(...)`` where ``f``'s return annotation names a class.

Unresolvable calls are silently skipped — the checkers stay sound for
what they claim (no false edges) at the cost of completeness, and the
**context annotations** (``# pathway-lint: context=<name>`` on thread
entry points) recover cross-module reach where resolution cannot: each
annotated function is its own propagation root.

The same symbol table powers lock identity: every ``threading.Lock`` /
``RLock`` / ``Condition`` assigned to a module global or a ``self``
attribute becomes a named lock symbol (``module.Class.attr``), with its
reentrancy kind, which the lock-order and signal-safety rules consume.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from pathway_tpu_torch.analysis.core import Project, SourceFile

_LOCK_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Event": "event",
    "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore",
}


def get_index(project: Project) -> "Index":
    """One shared symbol index per lint run (rules all reuse it)."""
    cached = getattr(project, "_index", None)
    if cached is None:
        cached = Index(project)
        project._index = cached  # type: ignore[attr-defined]
    return cached


def module_name_of(file: SourceFile) -> str:
    """Dotted module name; test files key by their basename."""
    parts = file.display_path.replace(os.sep, "/").split("/")
    if "pathway_tpu_torch" in parts:
        parts = parts[parts.index("pathway_tpu_torch"):]
    name = "/".join(parts)
    if name.endswith(".py"):
        name = name[:-3]
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


class FuncInfo:
    """One function or method definition."""

    __slots__ = (
        "qname", "name", "node", "file", "module", "class_name",
        "context", "nested", "parent",
    )

    def __init__(
        self,
        qname: str,
        node: ast.AST,
        file: SourceFile,
        module: str,
        class_name: str | None,
        parent: "FuncInfo | None",
    ):
        self.qname = qname
        self.name = node.name  # type: ignore[attr-defined]
        self.node = node
        self.file = file
        self.module = module
        self.class_name = class_name
        self.context = file.context_of_def(node)
        self.nested: dict[str, FuncInfo] = {}
        self.parent = parent


class ClassInfo:
    __slots__ = ("name", "module", "file", "bases", "methods", "attr_types", "lock_attrs", "node")

    def __init__(self, name: str, module: str, file: SourceFile, node: ast.ClassDef):
        self.name = name
        self.module = module
        self.file = file
        self.node = node
        self.bases: list[str] = []
        self.methods: dict[str, FuncInfo] = {}
        # self.<attr> -> class key ("module.Class") inferred from
        # constructor assignments anywhere in the class body
        self.attr_types: dict[str, str] = {}
        # self.<attr> -> lock kind ("lock"/"rlock"/"condition"/...)
        self.lock_attrs: dict[str, str] = {}

    @property
    def key(self) -> str:
        return f"{self.module}.{self.name}"


class ModuleInfo:
    __slots__ = (
        "name", "file", "imports", "from_imports", "functions",
        "classes", "constants", "module_locks",
    )

    def __init__(self, name: str, file: SourceFile):
        self.name = name
        self.file = file
        self.imports: dict[str, str] = {}  # alias -> dotted module
        self.from_imports: dict[str, tuple[str, str]] = {}  # name -> (module, orig)
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.constants: dict[str, str] = {}  # NAME -> string constant
        self.module_locks: dict[str, str] = {}  # NAME -> lock kind


class Index:
    """Project-wide symbol index + call resolution."""

    def __init__(self, project: Project):
        self.project = project
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FuncInfo] = {}  # qname -> info
        self.classes: dict[str, ClassInfo] = {}  # "module.Class" -> info
        self._env_cache: dict[str, dict[str, str]] = {}
        self._env_in_progress: set[str] = set()
        self._local_imports_cache: dict[
            str, tuple[dict[str, str], dict[str, tuple[str, str]]]
        ] = {}
        for f in project.files:
            self._index_file(f)
        self._infer_attr_types()

    # -- construction -------------------------------------------------------
    def _index_file(self, file: SourceFile) -> None:
        mod = ModuleInfo(module_name_of(file), file)
        if mod.name in self.modules:
            # test files may share basenames across roots; last wins but
            # functions keep unique qnames via the display path
            mod_key = file.display_path
        else:
            mod_key = mod.name
        self.modules[mod_key] = mod
        self._collect_imports(file.tree.body, mod)
        for node in file.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(node, file, mod, None, None)
            elif isinstance(node, ast.ClassDef):
                self._add_class(node, file, mod)
            elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
                if isinstance(node.value.value, str):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod.constants[t.id] = node.value.value
            if isinstance(node, ast.Assign):
                kind = self._lock_ctor_kind(node.value, mod)
                if kind is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod.module_locks[t.id] = kind

    def _collect_imports(self, body: Iterable[ast.stmt], mod: ModuleInfo) -> None:
        for node in body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    mod.from_imports[alias.asname or alias.name] = (
                        node.module, alias.name
                    )

    def _add_func(
        self,
        node: ast.AST,
        file: SourceFile,
        mod: ModuleInfo,
        cls: ClassInfo | None,
        parent: FuncInfo | None,
    ) -> FuncInfo:
        prefix = parent.qname if parent else (
            f"{mod.name}.{cls.name}" if cls else mod.name
        )
        qname = f"{prefix}.{node.name}"  # type: ignore[attr-defined]
        info = FuncInfo(qname, node, file, mod.name, cls.name if cls else None, parent)
        self.functions[qname] = info
        if parent is not None:
            parent.nested[info.name] = info
        elif cls is not None:
            cls.methods[info.name] = info
        else:
            mod.functions[info.name] = info
        for child in ast.walk(node):  # nested defs (closures, handlers)
            if child is node:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._direct_parent_func(node, child):
                    self._add_func(child, file, mod, cls, info)
        return info

    @staticmethod
    def _direct_parent_func(parent: ast.AST, child: ast.AST) -> bool:
        """True when no other function def sits between parent and child."""
        for mid in ast.walk(parent):
            if mid in (parent, child):
                continue
            if isinstance(mid, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(n is child for n in ast.walk(mid)):
                    return False
        return True

    def _add_class(self, node: ast.ClassDef, file: SourceFile, mod: ModuleInfo) -> None:
        cls = ClassInfo(node.name, mod.name, file, node)
        for base in node.bases:
            if isinstance(base, ast.Name):
                cls.bases.append(base.id)
            elif isinstance(base, ast.Attribute):
                cls.bases.append(base.attr)
        mod.classes[node.name] = cls
        self.classes[cls.key] = cls
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(item, file, mod, cls, None)

    def _lock_ctor_kind(self, value: ast.AST, mod: ModuleInfo) -> str | None:
        """Lock kind of ``threading.Lock()``-style constructor calls."""
        if not isinstance(value, ast.Call):
            return None
        fn = value.func
        name = None
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            target_mod = mod.imports.get(fn.value.id)
            if target_mod in ("threading", "multiprocessing"):
                name = fn.attr
        elif isinstance(fn, ast.Name):
            imp = mod.from_imports.get(fn.id)
            if imp is not None and imp[0] == "threading":
                name = imp[1]
        kind = _LOCK_KINDS.get(name or "")
        if kind == "condition":
            # Condition() wraps an RLock by default (reentrant); an
            # explicit Condition(some_plain_lock) inherits that lock's kind
            if value.args:
                inner = value.args[0]
                inner_kind = self._lock_ctor_kind(inner, mod)
                if inner_kind is not None:
                    return f"condition-{inner_kind}"
            return "condition"
        return kind

    def _infer_attr_types(self) -> None:
        """Fill ``ClassInfo.attr_types`` / ``lock_attrs`` from every
        ``self.x = Ctor(...)`` assignment in every method body."""
        for cls in self.classes.values():
            mod = self.modules.get(cls.module)
            if mod is None:
                mod = self.modules.get(cls.file.display_path)
            if mod is None:
                continue
            for node in ast.walk(cls.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        kind = self._lock_ctor_kind(node.value, mod)
                        if kind is not None:
                            cls.lock_attrs.setdefault(t.attr, kind)
                            continue
                        key = self._ctor_class_key(node.value, mod)
                        if key is not None:
                            cls.attr_types.setdefault(t.attr, key)

    def _ctor_class_key(self, value: ast.AST, mod: ModuleInfo) -> str | None:
        """"module.Class" when ``value`` is a project-class constructor."""
        if not isinstance(value, ast.Call):
            return None
        cls = self.resolve_class_expr(value.func, mod)
        return cls.key if cls is not None else None

    # -- lookup helpers -----------------------------------------------------
    def module_of(self, func: FuncInfo) -> ModuleInfo:
        mod = self.modules.get(func.module)
        if mod is None:
            mod = self.modules[func.file.display_path]
        return mod

    def class_of(self, func: FuncInfo) -> ClassInfo | None:
        if func.class_name is None:
            return None
        return self.classes.get(f"{func.module}.{func.class_name}")

    def resolve_class_expr(
        self, expr: ast.AST, mod: ModuleInfo
    ) -> ClassInfo | None:
        """A Name/Attribute expression naming a project class, if any."""
        if isinstance(expr, ast.Name):
            cls = mod.classes.get(expr.id)
            if cls is not None:
                return cls
            imp = mod.from_imports.get(expr.id)
            if imp is not None:
                other = self.modules.get(imp[0])
                if other is not None:
                    return other.classes.get(imp[1])
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            target = mod.imports.get(expr.value.id)
            if target is None:
                imp = mod.from_imports.get(expr.value.id)
                # `from pathway_tpu_torch.engine import persistence as pz`
                if imp is not None:
                    target = f"{imp[0]}.{imp[1]}"
            if target is not None:
                other = self.modules.get(target)
                if other is not None:
                    return other.classes.get(expr.attr)
        return None

    def resolve_annotation(
        self, ann: ast.AST | None, mod: ModuleInfo
    ) -> ClassInfo | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().strip('"').split("|")[0].strip()
            try:
                ann = ast.parse(name, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, (ast.Name, ast.Attribute)):
            return self.resolve_class_expr(ann, mod)
        return None

    def lookup_method(self, cls: ClassInfo, name: str) -> FuncInfo | None:
        """Method lookup through statically-known bases (same project)."""
        seen: set[str] = set()
        stack = [cls]
        while stack:
            cur = stack.pop(0)
            if cur.key in seen:
                continue
            seen.add(cur.key)
            if name in cur.methods:
                return cur.methods[name]
            mod = self.modules.get(cur.module)
            for base in cur.bases:
                resolved = None
                if mod is not None:
                    resolved = self.resolve_class_expr(
                        ast.Name(id=base), mod
                    )
                if resolved is not None:
                    stack.append(resolved)
        return None

    def lock_attr_kind(self, cls: ClassInfo, attr: str) -> str | None:
        seen: set[str] = set()
        stack = [cls]
        while stack:
            cur = stack.pop(0)
            if cur.key in seen:
                continue
            seen.add(cur.key)
            if attr in cur.lock_attrs:
                return cur.lock_attrs[attr]
            mod = self.modules.get(cur.module)
            for base in cur.bases:
                resolved = (
                    self.resolve_class_expr(ast.Name(id=base), mod)
                    if mod is not None
                    else None
                )
                if resolved is not None:
                    stack.append(resolved)
        return None

    # -- per-function environments ------------------------------------------
    def local_env(self, func: FuncInfo) -> dict[str, str]:
        """var name -> "module.Class" for constructor-assigned locals and
        annotated parameters of ``func`` (own body only, not nested).

        Memoized, with an in-progress guard: resolving ``x = f()`` needs
        ``f``'s callee set, which may need *this* env again (mutually
        recursive helpers).  Re-entry returns the empty env — sound
        (fewer resolved edges), and it bounds the recursion."""
        cached = self._env_cache.get(func.qname)
        if cached is not None:
            return cached
        if func.qname in self._env_in_progress:
            return {}
        self._env_in_progress.add(func.qname)
        try:
            env = self._compute_local_env(func)
        finally:
            self._env_in_progress.discard(func.qname)
        self._env_cache[func.qname] = env
        return env

    def _compute_local_env(self, func: FuncInfo) -> dict[str, str]:
        mod = self.module_of(func)
        env: dict[str, str] = {}
        args = func.node.args  # type: ignore[attr-defined]
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            cls = self.resolve_annotation(a.annotation, mod)
            if cls is not None:
                env[a.arg] = cls.key
        for node in self._own_nodes(func):
            if isinstance(node, ast.Assign):
                key = self._ctor_class_key(node.value, mod)
                if key is None and isinstance(node.value, ast.Call):
                    # x = make_thing() through a return annotation
                    ret = self._call_return_class(node.value, func)
                    key = ret.key if ret is not None else None
                if key is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            env.setdefault(t.id, key)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                cls = self.resolve_annotation(node.annotation, mod)
                if cls is not None:
                    env.setdefault(node.target.id, cls.key)
        return env

    def local_lock_env(self, func: FuncInfo) -> dict[str, str]:
        """var name -> lock kind for locals assigned lock constructors."""
        mod = self.module_of(func)
        env: dict[str, str] = {}
        for node in self._own_nodes(func):
            if isinstance(node, ast.Assign):
                kind = self._lock_ctor_kind(node.value, mod)
                if kind is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            env.setdefault(t.id, kind)
        return env

    def _own_nodes(self, func: FuncInfo) -> Iterable[ast.AST]:
        """Walk ``func``'s body, not descending into nested defs."""
        stack: list[ast.AST] = list(ast.iter_child_nodes(func.node))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _call_return_class(
        self, call: ast.Call, caller: FuncInfo
    ) -> ClassInfo | None:
        """Class named by the return annotation of a resolvable call."""
        for callee in self.resolve_call(call, caller):
            returns = getattr(callee.node, "returns", None)
            cls = self.resolve_annotation(returns, self.module_of(callee))
            if cls is not None:
                return cls
        return None

    # -- call resolution ----------------------------------------------------
    def resolve_call(self, call: ast.Call, caller: FuncInfo) -> list[FuncInfo]:
        mod = self.module_of(caller)
        fn = call.func
        out: list[FuncInfo] = []
        if isinstance(fn, ast.Name):
            # nested defs of this function, then the enclosing chain
            cursor: FuncInfo | None = caller
            while cursor is not None:
                if fn.id in cursor.nested:
                    return [cursor.nested[fn.id]]
                cursor = cursor.parent
            if fn.id in mod.functions:
                return [mod.functions[fn.id]]
            imp = mod.from_imports.get(fn.id)
            if imp is not None:
                other = self.modules.get(imp[0])
                if other is not None and imp[1] in other.functions:
                    return [other.functions[imp[1]]]
            cls = self.resolve_class_expr(fn, mod)
            if cls is not None:
                init = self.lookup_method(cls, "__init__")
                if init is not None:
                    return [init]
            return out
        if not isinstance(fn, ast.Attribute):
            return out
        recv = fn.value
        # function-level lazy imports are collected per-function
        local_imports, local_from = self._local_imports(caller)
        if isinstance(recv, ast.Name):
            if recv.id == "self" and caller.class_name is not None:
                cls = self.class_of(caller)
                if cls is not None:
                    method = self.lookup_method(cls, fn.attr)
                    if method is not None:
                        return [method]
                return out
            target_mod = local_imports.get(recv.id) or mod.imports.get(recv.id)
            if target_mod is None:
                imp = local_from.get(recv.id) or mod.from_imports.get(recv.id)
                if imp is not None and imp[1][:1].islower():
                    target_mod = f"{imp[0]}.{imp[1]}"
            if target_mod is not None:
                other = self.modules.get(target_mod)
                if other is not None:
                    if fn.attr in other.functions:
                        return [other.functions[fn.attr]]
                    cls = other.classes.get(fn.attr)
                    if cls is not None:
                        init = self.lookup_method(cls, "__init__")
                        return [init] if init is not None else out
                return out
            env = self.local_env(caller)
            key = env.get(recv.id)
            if key is not None and key in self.classes:
                method = self.lookup_method(self.classes[key], fn.attr)
                if method is not None:
                    return [method]
            return out
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and caller.class_name is not None
        ):
            cls = self.class_of(caller)
            if cls is not None:
                key = cls.attr_types.get(recv.attr)
                if key is not None and key in self.classes:
                    method = self.lookup_method(self.classes[key], fn.attr)
                    if method is not None:
                        return [method]
            return out
        if isinstance(recv, ast.Call):
            cls = self._call_return_class(recv, caller)
            if cls is not None:
                method = self.lookup_method(cls, fn.attr)
                if method is not None:
                    return [method]
        return out

    def _local_imports(
        self, func: FuncInfo
    ) -> tuple[dict[str, str], dict[str, tuple[str, str]]]:
        cached = self._local_imports_cache.get(func.qname)
        if cached is not None:
            return cached
        imports: dict[str, str] = {}
        from_imports: dict[str, tuple[str, str]] = {}
        cursor: FuncInfo | None = func
        while cursor is not None:  # closures see enclosing lazy imports
            for node in self._own_nodes(cursor):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        imports.setdefault(
                            alias.asname or alias.name.split(".")[0], alias.name
                        )
                elif isinstance(node, ast.ImportFrom) and node.module:
                    for alias in node.names:
                        from_imports.setdefault(
                            alias.asname or alias.name, (node.module, alias.name)
                        )
            cursor = cursor.parent
        self._local_imports_cache[func.qname] = (imports, from_imports)
        return imports, from_imports

    # -- context propagation ------------------------------------------------
    def propagate_contexts(self) -> dict[str, dict[str, str]]:
        """{func qname: {context: root-chain}} — every execution context a
        function is statically reachable from, with the call chain that
        proves it (for finding messages).

        Roots are the ``# pathway-lint: context=<name>`` annotations.  A
        function annotated with its OWN context is a boundary: contexts do
        not propagate through it (a thread entry point reached by another
        thread's code is still its own context)."""
        contexts: dict[str, dict[str, str]] = {}
        queue: list[tuple[FuncInfo, str, str]] = []
        for func in self.functions.values():
            if func.context is not None:
                contexts.setdefault(func.qname, {})[func.context] = func.qname
                queue.append((func, func.context, func.qname))
        while queue:
            func, ctx, chain = queue.pop(0)
            for call in self._own_calls(func):
                for callee in self.resolve_call(call, func):
                    if callee.context is not None and callee.context != ctx:
                        continue  # its own thread context: a boundary
                    slot = contexts.setdefault(callee.qname, {})
                    if ctx in slot:
                        continue
                    slot[ctx] = f"{chain} -> {callee.qname}"
                    queue.append((callee, ctx, slot[ctx]))
        return contexts

    def _own_calls(self, func: FuncInfo) -> Iterable[ast.Call]:
        for node in self._own_nodes(func):
            if isinstance(node, ast.Call):
                yield node

    # -- lock identity ------------------------------------------------------
    def resolve_lock_expr(
        self, func: FuncInfo, expr: ast.AST
    ) -> tuple[str, str] | None:
        """(symbol id, kind) when ``expr`` names a known lock: a module
        global, a local assigned a lock constructor, ``self.<attr>``, or
        ``<typed var>.<attr>`` / ``self.<typed attr>.<attr>``.  Lock
        symbols conflate instances by (class, attribute) — the classic
        lock-ORDER discipline is about lock classes, not objects."""
        mod = self.module_of(func)
        if isinstance(expr, ast.Name):
            kind = self.local_lock_env(func).get(expr.id)
            if kind is not None:
                return (f"{func.qname}.{expr.id}", kind)
            kind = mod.module_locks.get(expr.id)
            if kind is not None:
                return (f"{mod.name}.{expr.id}", kind)
            return None
        if not isinstance(expr, ast.Attribute):
            return None
        recv = expr.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and func.class_name is not None:
                cls = self.class_of(func)
                if cls is not None:
                    kind = self.lock_attr_kind(cls, expr.attr)
                    if kind is not None:
                        return (f"{cls.key}.{expr.attr}", kind)
                return None
            target_mod = mod.imports.get(recv.id)
            if target_mod is not None:
                other = self.modules.get(target_mod)
                if other is not None:
                    kind = other.module_locks.get(expr.attr)
                    if kind is not None:
                        return (f"{other.name}.{expr.attr}", kind)
                return None
            key = self.local_env(func).get(recv.id)
            if key is not None and key in self.classes:
                kind = self.lock_attr_kind(self.classes[key], expr.attr)
                if kind is not None:
                    return (f"{key}.{expr.attr}", kind)
            return None
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and func.class_name is not None
        ):
            cls = self.class_of(func)
            if cls is not None:
                key = cls.attr_types.get(recv.attr)
                if key is not None and key in self.classes:
                    kind = self.lock_attr_kind(self.classes[key], expr.attr)
                    if kind is not None:
                        return (f"{key}.{expr.attr}", kind)
        return None
