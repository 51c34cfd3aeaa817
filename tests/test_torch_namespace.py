"""The port has every module and every public name of the JAX package.

For each module of ``pathway_tpu/``, found by walking its file tree, the
module of the same path under ``pathway_tpu_torch/`` must import and have
every public name of the JAX module: its ``__all__``, or else its public
top-level functions and classes (read from the JAX source, so no JAX
module is imported here).  The command lines are compared by their
subcommands.  ``EXCEPTIONS`` lists all that the port leaves out, each
with its reason.
"""

from __future__ import annotations

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "pathway_tpu")

EXCEPTIONS = {
    "parallel/_compat.py": "a shim over JAX versions (shard_map's home moved); PyTorch needs none",
    "cli bench": "runs the JAX package's own benchmarks/ harness; the port's benchmark comes on its own",
}


def jax_modules() -> list[str]:
    """Every module file of the JAX package, relative to its root."""
    out = []
    for dirpath, dirnames, filenames in os.walk(JAX_ROOT):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_ROOT) for f in sorted(filenames) if f.endswith(".py")]
    return out


def public_names(path: str) -> list[str]:
    """A module's ``__all__`` when it is a literal, else its public
    top-level functions and classes."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def module_name(rel: str) -> str:
    name = "pathway_tpu_torch." + rel[:-3].replace(os.sep, ".")
    return name.removesuffix(".__init__")


MODULES = [rel for rel in jax_modules() if rel != "cli.py"]


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_module_and_names(rel):
    if rel in EXCEPTIONS:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(module_name(rel))
        return
    module = importlib.import_module(module_name(rel))
    missing = [n for n in public_names(os.path.join(JAX_ROOT, rel)) if not hasattr(module, n)]
    assert not missing, f"{module.__name__} lacks {missing}"


def subcommands(parser) -> dict:
    """``{name: nested subcommands}`` of an argparse parser."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = subcommands(sub)
    return out


def click_commands(group) -> dict:
    return {name: click_commands(cmd) if hasattr(cmd, "commands") else {}
            for name, cmd in group.commands.items()}


def test_cli_subcommands_match_jax():
    from pathway_tpu import cli as jcli
    from pathway_tpu_torch import cli as tcli

    want = click_commands(jcli.cli)
    got = subcommands(tcli._parser())
    left_out = {name.split()[1] for name in EXCEPTIONS if name.startswith("cli ")}
    assert left_out <= set(want) and not left_out & set(got)
    assert got == {k: v for k, v in want.items() if k not in left_out}

