"""The port's static analyzer against the JAX package's.

Both analyzers lint ``tests/lint_corpus/`` (read, never edited) to the
same findings, suppressions and rule catalogue, with the package name and
the generated page's name normalised; the port's own tree lints clean
with exactly one suppression; ``docs/torch_configuration.md`` is its
registry's render; and the registry rules fire on fake trees.  The port's
tree is linted once, by a module-scoped fixture.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest

from pathway_tpu import analysis as janalysis
from pathway_tpu_torch import analysis as tanalysis
from pathway_tpu_torch import cli as tcli

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CORPUS = os.path.join(HERE, "lint_corpus")
PORT = os.path.join(REPO, "pathway_tpu_torch")


def normalised(report) -> dict:
    text = json.dumps(report.to_json(), sort_keys=True)
    return json.loads(text.replace("pathway_tpu_torch", "pathway_tpu").replace("torch_configuration.md",
                                                                               "configuration.md"))


@pytest.fixture(scope="module")
def port_report():
    return tanalysis.run_lint([PORT])


def cli(*argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = tcli.main(list(argv))
    return code, out.getvalue()


def test_corpus_findings_match_jax():
    want, got = (normalised(a.run_lint([CORPUS])) for a in (janalysis, tanalysis))
    assert want["findings"] and want["suppressed"]
    assert got == want


def test_rule_catalogues_match_jax():
    code, text = cli("lint", "--list-rules")
    assert code == 0
    rows = [line.split(None, 1) for line in text.splitlines()]
    assert [rid for rid, _doc in rows] == sorted(janalysis.RULES)
    assert {rid: doc.replace("torch_configuration.md", "configuration.md") for rid, doc in rows} == {
        rid: rule.doc for rid, rule in janalysis.RULES.items()}


def test_port_tree_is_clean_with_one_suppression(port_report):
    assert not port_report.findings, tanalysis.report_to_text(port_report)
    assert [(s.path.replace(os.sep, "/").split("pathway_tpu_torch/")[-1], s.rules)
            for s in port_report.suppressions] == [("engine/faults.py", ("ctx-blocking-call",))]
    assert len(port_report.suppressed) == 1


def test_generated_config_docs_in_sync():
    from pathway_tpu_torch.internals.config import ENV_KNOBS, render_env_docs

    with open(os.path.join(REPO, "docs", "torch_configuration.md"), encoding="utf-8") as f:
        assert f.read() == render_env_docs()
    names = {k.name for k in ENV_KNOBS}
    assert {"PATHWAY_ENCODER_QUANTIZE", "PATHWAY_FUSED_ENCODER", "PATHWAY_GENERATE_CONTINUOUS"} <= names


def test_registry_rules_fire_on_fake_tree(tmp_path):
    pkg = tmp_path / "pathway_tpu_torch" / "internals"
    pkg.mkdir(parents=True)
    (pkg / "config.py").write_text("X = 1\n", encoding="utf-8")
    (pkg / "reader.py").write_text(
        "import os\n\nFUSED = os.environ.get('PATHWAY_FUSED_ENCODER')\n", encoding="utf-8")
    report = tanalysis.run_lint([str(tmp_path)], rules=["env-direct-read", "env-docs-stale"])
    assert [(f.rule, f.line) for f in report.findings] == [("env-docs-stale", 1), ("env-direct-read", 3)]
    assert "missing" in report.findings[0].message
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "torch_configuration.md").write_text("hand-edited\n", encoding="utf-8")
    report = tanalysis.run_lint([str(tmp_path)], rules=["env-docs-stale"])
    assert [f.rule for f in report.findings] == ["env-docs-stale"]
    assert "does not match" in report.findings[0].message


def test_cli_lint_exit_codes():
    code, text = cli("lint", "--json", CORPUS)
    assert code == 1 and json.loads(text)["ok"] is False
    code, text = cli("lint", os.path.join(PORT, "analysis", "chaos.py"))
    assert code == 0, text
    assert cli("lint", "--rules", "bogus", CORPUS)[0] == 2
