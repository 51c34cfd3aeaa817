"""``pathway_tpu_torch.analysis`` — the repo-native static analyzer.

Public surface:

* :func:`run_lint` — lint a set of paths with every registered rule (or
  a subset), returning a deterministic :class:`~.core.Report`;
* :data:`RULES` — the rule catalogue (id → :class:`~.core.Rule`), the
  source of truth ``docs/static_analysis.md`` documents;
* the ``python -m pathway_tpu_torch lint`` CLI subcommand
  (``pathway_tpu_torch/cli.py``) and the port's gate
  (``tests/test_torch_analysis.py``) both call :func:`run_lint`.

A copy of ``pathway_tpu/analysis/`` whose package anchors name
``pathway_tpu_torch``: the call graph resolves the port's modules, the
registry rules read the port's ``ENV_REGISTRY`` and ``METRICS``, and
``env-docs-stale`` holds ``docs/torch_configuration.md``.  The catalogue
is kept whole: the ``jit-*`` rules (``jit.py``, an AST pass) find nothing
in a tree without ``jax.jit``.

See ``docs/static_analysis.md`` for the rule catalogue, the context
annotation syntax (``# pathway-lint: context=epoch``), the suppression
syntax (``# pathway-lint: disable=<rule> — <reason>``), and how to add
a rule.
"""

from __future__ import annotations

from typing import Iterable

from pathway_tpu_torch.analysis import chaos, contexts, jit, locks, registries
from pathway_tpu_torch.analysis.core import (
    Finding,
    Project,
    Report,
    Rule,
    load_project,
    report_to_text,
    run_rules,
)

__all__ = [
    "Finding",
    "Project",
    "Report",
    "Rule",
    "RULES",
    "load_project",
    "report_to_text",
    "run_lint",
]

RULES: dict[str, Rule] = {
    rule.id: rule
    for module in (contexts, locks, registries, jit, chaos)
    for rule in module.RULES
}


def run_lint(
    paths: Iterable[str], *, rules: Iterable[str] | None = None
) -> Report:
    """Lint every ``.py`` under ``paths`` and return the report.

    ``rules`` selects a subset by id (default: all).  Corpus directories
    (``lint_corpus``) are skipped unless targeted explicitly — they hold
    deliberate violations for the golden tests.
    """
    selected: list[Rule]
    if rules is None:
        selected = [RULES[k] for k in sorted(RULES)]
    else:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {unknown}; known: {sorted(RULES)}"
            )
        selected = [RULES[k] for k in sorted(set(rules))]
    project = load_project(paths)
    return run_rules(project, selected, known_ids=set(RULES))
