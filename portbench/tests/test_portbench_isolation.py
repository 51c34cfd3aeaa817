"""Nothing the benchmark runs imports JAX, Flax or the JAX package
(compared by whole top-level module name), the reference imports nothing
of the program, and nothing of the benchmark reads the JAX package's
benchmark folder or script."""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent

BLOCKER = """
import sys
BLOCKED = set(sys.argv[1].split(","))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
"""


def run_blocked(blocked: str, body: str, timeout: float = 300) -> subprocess.CompletedProcess:
    code = BLOCKER + body
    return subprocess.run([sys.executable, "-c", code, blocked], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)})


def test_blocker_compares_whole_top_level_names():
    res = run_blocked("jax,flax,pathway_tpu", "import pathway_tpu_torch\ntry:\n    import pathway_tpu\nexcept ImportError:\n    print('blocked')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "blocked"


def test_every_module_of_the_benchmark_imports_without_jax():
    body = """
import importlib, pkgutil
from pathlib import Path
import portbench
from portbench import harness
names = [m.name for m in pkgutil.walk_packages(portbench.__path__, "portbench.") if ".tests" not in m.name]
for n in names:
    importlib.import_module(n)
for kind in ("metrics", "generators"):
    for f in sorted((Path(portbench.__file__).parent / kind).glob("*.py")):
        harness.load_module(f, "x_" + f.stem)
print(len(names))
"""
    res = run_blocked("jax,jaxlib,flax,pathway_tpu", body)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 10


def test_the_reference_imports_nothing_of_the_program():
    body = """
import torch
from portbench.reference import bert, mistral, text, topk, strict_f32
from portbench import weights
t = weights.bert_tree({"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 2, "vocab_size": 200,
                       "max_position_embeddings": 16, "num_hidden_layers": 1}, 1, "cpu")
print(bert.embed(t, [[101, 150, 102]], 2, "cls", "cpu").shape)
import sys
print(sorted(m for m in sys.modules if m.split(".")[0] == "pathway_tpu_torch"))
"""
    res = run_blocked("jax,jaxlib,flax,pathway_tpu,pathway_tpu_torch", body)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_a_tiny_run_of_each_cell_loads_no_jax():
    body = """
import tempfile
from pathlib import Path
from portbench import harness
from portbench.tests import tiny
root = Path(tempfile.mkdtemp())
bench = tiny.make(root)
for name in ("tiny_ingest", "tiny_answers"):
    res = harness.run_cell(bench, tiny.workload(bench, name), 5, 1.5, False, device="cpu",
                           reference_device="cpu", root=root)
    assert res["correct"], res["checks"]
print(harness.forbidden_modules())
"""
    res = run_blocked("jax,jaxlib,flax,pathway_tpu", body, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_nothing_reads_the_jax_packages_benchmark():
    for path in PKG.rglob("*.py"):
        if "tests" in path.relative_to(PKG).parts:
            continue
        src = path.read_text()
        assert "benchmarks" not in src and "bench.py" not in src and "BENCH_" not in src, path
