"""Repo-native static analysis: findings, suppressions, the lint entry point.

``python -m pathway_tpu_torch lint`` is a compiler-grade pass over the package's own
source: the threaded runtime (epoch loop, async writer
pool + committer, supervisor watchdog, SIGUSR1 flight-recorder handler,
telemetry export queue) runs on invariants that break *silently* — an
epoch thread that blocks, a signal handler that touches a plain lock, a
``jax.jit`` call site that recompiles per batch.  Each rule here proves
one of those properties statically, before a change lands, instead of
hoping a benchmark on a noisy rig notices the regression.

Design:

* **Findings** carry ``file:line`` + a stable rule id, so the output is
  diffable and the gate test can pin exact locations for the golden
  corpus.
* **Suppressions** are inline and *audited*: ``# pathway-lint:
  disable=<rule> — <reason>`` on the flagged line (or up to two lines
  above).  A suppression without a reason is itself a finding
  (``bad-suppression``), and one that silences nothing is too
  (``unused-suppression``) — the suppression count is a ratchet, not an
  escape hatch.
* **Determinism**: two runs over the same tree produce byte-identical
  reports (findings sort by path, line, rule; no wall-clock or hashing
  order leaks in).

Rules live in sibling modules (``contexts``, ``locks``, ``registries``,
``jit``, ``chaos``); each exports ``Rule`` instances registered in
``pathway_tpu_torch.analysis.RULES``.  ``docs/static_analysis.md`` is the rule
catalogue.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable

# Matches one suppression comment.  The reason is MANDATORY, separated by
# an em-dash or ASCII dashes: `# pathway-lint: disable=<rule> — <reason>`
# (the placeholder form is deliberate here — a concrete rule id in this
# comment would itself parse as a suppression).
_SUPPRESS_RE = re.compile(
    r"#\s*pathway-lint:\s*disable=([a-z0-9,\-]+)\s*(?:—|--|-)?\s*(.*)$"
)
# Context annotation on (or directly above) a `def` line:
# `# pathway-lint: context=epoch`
_CONTEXT_RE = re.compile(r"#\s*pathway-lint:\s*context=([a-z\-]+)")

# Corpus/example trees are deliberately full of violations; they are only
# linted when targeted explicitly (the golden-corpus test does).
_SKIP_DIR_NAMES = {"__pycache__", "lint_corpus", ".git", "node_modules"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # path as given (project-relative when possible)
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


@dataclasses.dataclass
class Suppression:
    """One parsed ``# pathway-lint: disable=...`` comment."""

    path: str
    line: int  # line the comment sits on
    rules: tuple[str, ...]
    reason: str
    used: bool = False

    def covers(self, finding_line: int) -> bool:
        """A suppression covers its own line and the two lines below —
        the same window the chaos-lint marker uses, so one idiom serves
        both: annotate on the flagged line or just above it."""
        return self.line <= finding_line <= self.line + 2


class SourceFile:
    """One parsed source file: text, AST, suppressions, context marks."""

    def __init__(self, path: str, display_path: str, text: str):
        self.path = path
        self.display_path = display_path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=display_path)
        self.suppressions: list[Suppression] = []
        self.parse_error: str | None = None
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m is not None:
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                self.suppressions.append(
                    Suppression(
                        path=display_path,
                        line=i,
                        rules=rules,
                        reason=m.group(2).strip(),
                    )
                )

    # -- annotation helpers -------------------------------------------------
    def context_of_def(self, node: ast.AST) -> str | None:
        """The ``context=<name>`` annotation attached to a function: on
        the ``def`` line itself or one of the two lines directly above
        (above the decorators, when present)."""
        first = getattr(node, "lineno", None)
        if first is None:
            return None
        deco = getattr(node, "decorator_list", None) or []
        if deco:
            first = min(first, min(d.lineno for d in deco))
        for lineno in range(first, max(0, first - 3), -1):
            if 1 <= lineno <= len(self.lines):
                m = _CONTEXT_RE.search(self.lines[lineno - 1])
                if m is not None:
                    return m.group(1)
        return None

    @property
    def is_test(self) -> bool:
        base = os.path.basename(self.display_path)
        parts = self.display_path.replace(os.sep, "/").split("/")
        if "lint_corpus" in parts:
            # corpus snippets are linted AS package code when targeted
            # explicitly — the golden tests prove package-scoped rules
            # fire, which a test-file classification would mask
            return False
        return "tests" in parts or base.startswith("test_")


class Project:
    """The set of files one lint run sees, package and test files alike."""

    def __init__(self, files: list[SourceFile]):
        self.files = sorted(files, key=lambda f: f.display_path)
        self._broken: list[tuple[str, str]] = []

    @property
    def package_files(self) -> list[SourceFile]:
        return [f for f in self.files if not f.is_test]

    @property
    def test_files(self) -> list[SourceFile]:
        return [f for f in self.files if f.is_test]


class Rule:
    """One lint rule: a stable id, a one-line doc, and a check."""

    def __init__(
        self,
        rule_id: str,
        doc: str,
        check: Callable[[Project], Iterable[Finding]],
    ):
        self.id = rule_id
        self.doc = doc
        self._check = check

    def run(self, project: Project) -> list[Finding]:
        return list(self._check(project))


@dataclasses.dataclass
class Report:
    """The outcome of one lint run."""

    findings: list[Finding]  # unsuppressed — these fail the gate
    suppressed: list[Finding]  # silenced by a valid suppression
    suppressions: list[Suppression]  # every suppression comment seen
    files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "suppressions": [
                {
                    "path": s.path,
                    "line": s.line,
                    "rules": list(s.rules),
                    "reason": s.reason,
                }
                for s in self.suppressions
            ],
        }

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"pathway-lint: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed "
            f"({len(self.suppressions)} suppression comment(s)) "
            f"across {self.files} file(s)"
        )
        return "\n".join(lines)


def _iter_py_files(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = sorted(
            d for d in dirnames if d not in _SKIP_DIR_NAMES
        )
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def load_project(paths: Iterable[str]) -> Project:
    """Parse every ``.py`` under ``paths`` (files or directories) into a
    :class:`Project`.  A file that does not parse is reported as a
    ``parse-error`` finding rather than aborting the run — the linter
    must degrade like a compiler, not crash like a script."""
    files: list[SourceFile] = []
    broken: list[tuple[str, str, int]] = []
    seen: set[str] = set()
    cwd = os.getcwd()
    for root in paths:
        for path in _iter_py_files(root):
            real = os.path.realpath(path)
            if real in seen:
                continue
            seen.add(real)
            display = os.path.relpath(path, cwd)
            if display.startswith(".."):
                display = path
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
                files.append(SourceFile(path, display, text))
            except SyntaxError as exc:
                broken.append((display, str(exc.msg), exc.lineno or 1))
            except (OSError, ValueError) as exc:
                broken.append((display, str(exc), 1))
    project = Project(files)
    project._broken = [(p, m) for p, m, _ in broken]
    project._broken_findings = [  # type: ignore[attr-defined]
        Finding("parse-error", p, line, f"file does not parse: {m}")
        for p, m, line in broken
    ]
    return project


def run_rules(
    project: Project,
    rules: Iterable[Rule],
    *,
    known_ids: set[str] | None = None,
) -> Report:
    """Run ``rules`` over ``project`` and fold in the suppression audit.

    ``known_ids`` is the full rule universe (for validating suppression
    comments when only a subset of rules runs); defaults to the ids of
    ``rules``."""
    rules = list(rules)
    raw: list[Finding] = list(
        getattr(project, "_broken_findings", [])
    )
    for rule in rules:
        raw.extend(rule.run(project))

    suppressions: list[Suppression] = []
    by_path: dict[str, list[Suppression]] = {}
    for f in project.files:
        for s in f.suppressions:
            suppressions.append(s)
            by_path.setdefault(s.path, []).append(s)

    kept: list[Finding] = []
    silenced: list[Finding] = []
    for finding in raw:
        match = None
        for s in by_path.get(finding.path, ()):
            if finding.rule in s.rules and s.covers(finding.line):
                match = s
                break
        if match is not None:
            match.used = True
            silenced.append(finding)
        else:
            kept.append(finding)

    # the suppression audit: every comment needs a reason and a purpose
    selected = {r.id for r in rules}
    known = (known_ids if known_ids is not None else selected) | {"parse-error"}
    for s in suppressions:
        if not any(r in selected for r in s.rules) and all(
            r in known for r in s.rules
        ):
            continue  # none of its rules ran: no basis to audit usage
        unknown = [r for r in s.rules if r not in known]
        if unknown:
            kept.append(
                Finding(
                    "bad-suppression",
                    s.path,
                    s.line,
                    f"suppression names unknown rule(s) {unknown}",
                )
            )
            continue
        if not s.reason:
            kept.append(
                Finding(
                    "bad-suppression",
                    s.path,
                    s.line,
                    "suppression without a reason — write `# pathway-lint: "
                    "disable=<rule> — <why this is safe>`",
                )
            )
        elif not s.used:
            kept.append(
                Finding(
                    "unused-suppression",
                    s.path,
                    s.line,
                    f"suppression for {','.join(s.rules)} silences nothing "
                    "— delete it (the ratchet counts suppressions)",
                )
            )

    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    silenced.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    suppressions.sort(key=lambda s: (s.path, s.line))
    return Report(
        findings=kept,
        suppressed=silenced,
        suppressions=suppressions,
        files=len(project.files),
    )


def report_to_text(report: Report, *, as_json: bool = False) -> str:
    if as_json:
        return json.dumps(report.to_json(), indent=2, sort_keys=True)
    return report.render()
