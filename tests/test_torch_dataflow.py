"""The port's dataflow core and Table API against the JAX package's.

Each program of ``tests/torch_dataflow_programs.py`` (per-row work,
grouping, joins, streams with retractions, UDFs) runs through
``pathway_tpu`` and through ``pathway_tpu_torch``, on the columnar path
and on the row path (``PATHWAY_COLUMNAR=0``, here
``vector_compiler.set_enabled(False)``); the change streams of every
table, ``(key, row, time, diff)`` with keys and float bits, must be equal
between the packages on each path.  The port's pure-Python core
(``PATHWAY_NATIVE=0``, in a subprocess started with it) must give the
native core's streams on both paths, bit for bit.  Between the two paths
everything is equal but a float sum's last bits: the columnar path sums
a batch with numpy, the row path one value at a time, in both packages
alike, so floats there are held at 1e-12.  Two processes building the
port's native core into one empty directory at once must both load it.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest

import pathway_tpu as pj
import pathway_tpu_torch as pt
from pathway_tpu.internals import vector_compiler as jvc
from pathway_tpu_torch import native
from pathway_tpu_torch.internals import vector_compiler as vc
from tests import torch_dataflow_programs as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(P.PROGRAMS)
PATHS = {True: "columnar", False: "row"}
SUM_ORDER_TOL = 1e-12


def on_path(pw, compiler, columnar: bool) -> dict:
    """Every program of ``pw`` with the columnar path on or off."""
    compiler.set_enabled(columnar)
    try:
        return {name: P.capture_program(pw, name) for name in NAMES}
    finally:
        compiler.set_enabled(True)


def same_but_sum_order(a, b) -> bool:
    """Canonical values equal, but floats (given by their bits) within
    ``SUM_ORDER_TOL``: the rounding of one sum in another order."""
    if isinstance(a, tuple) and len(a) == 2 and a[0] == b[0] == "float":
        x, y = float.fromhex(a[1]), float.fromhex(b[1])
        return math.isclose(x, y, rel_tol=SUM_ORDER_TOL, abs_tol=SUM_ORDER_TOL)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(same_but_sum_order(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def python_core_run(tmp_path_factory):
    """Every program of the port under ``PATHWAY_NATIVE=0``, started in a
    subprocess at the module's first test and read when first needed."""
    out = tmp_path_factory.mktemp("python_core") / "deltas.pkl"
    proc = P.spawn_python_core(out)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def build_race(tmp_path_factory):
    """Two processes, started together at the module's first test, that
    build the native core into one empty directory and load it."""
    build = tmp_path_factory.mktemp("native") / "build"
    code = (
        "import sys\n"
        "from pathway_tpu_torch import native\n"
        "mod = native.get()\n"
        "sys.exit(0 if mod is not None and mod.__file__.startswith(sys.argv[1]) else 3)\n"
    )
    env = dict(os.environ, PATHWAY_NATIVE_BUILD_DIR=str(build), PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    yield build, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def python_core(python_core_run) -> dict:
    return P.python_core_result(*python_core_run)


@pytest.fixture(scope="module")
def port(python_core_run, build_race) -> dict:
    """The port's streams on its native core, on each path."""
    assert native.get() is not None and vc.ENABLED
    return {columnar: on_path(pt, vc, columnar) for columnar in PATHS}


@pytest.fixture(scope="module")
def jax_streams() -> dict:
    return {columnar: on_path(pj, jvc, columnar) for columnar in PATHS}


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", NAMES)
def test_program_matches_jax(port, jax_streams, name, columnar):
    want, got = jax_streams[columnar][name], port[columnar][name]
    assert sorted(got) == sorted(want)
    for table, deltas in want.items():
        assert deltas, table  # every table of every program produced rows
        assert got[table] == deltas, table


@pytest.mark.parametrize("name", NAMES)
def test_row_path_matches_columnar(port, name):
    for table, deltas in port[True][name].items():
        assert same_but_sum_order(port[False][name][table], deltas), table


@pytest.mark.parametrize("columnar", list(PATHS), ids=list(PATHS.values()))
@pytest.mark.parametrize("name", NAMES)
def test_python_core_matches_native(port, python_core, name, columnar):
    assert python_core[columnar][name] == port[columnar][name]


def test_streams_hold_retractions_errors_and_async_values(port):
    """The programs reach what they are for: retractions of computed rows,
    updates of one key within an epoch, and ``ERROR`` from a raising UDF."""
    udfs = port[True]["udfs"]
    assert any(d < 0 for _t, _k, d, _r in udfs["async"])
    assert sum(1 for *_, row in udfs["error"] if ("Error",) in row[1]) == 20
    keys_at = {}
    for t, k, d, _r in port[True]["streams"]["select"]:
        keys_at.setdefault((t, k), set()).add(d)
    assert any(ds == {-1, 1} for ds in keys_at.values())


def test_columnar_bails_reach_the_ports_registry(port):
    """``grouping``'s sparse sum bails off the columnar path, counted in
    the port's own metrics registry as the JAX package counts it."""
    from pathway_tpu_torch.engine import metrics

    assert vc.BAIL_COUNTS[("groupby", "dirty-column")] > 0
    family = metrics.get_registry().family("columnar.bail.count")
    assert family is not None and sum(child.value for _, child in family.items()) > 0


def test_tensor_values_become_arrays():
    """A ``torch.Tensor`` cell is stored as the numpy array the JAX package
    stores for the same values (``internals/dtype.py``'s coerce)."""
    import numpy as np
    import torch

    def program(pw, make):
        t = pw.debug.table_from_markdown("x\n1\n2\n5")
        return {"v": t.select(y=pw.apply_with_type(lambda x: make([x, 0.5 * x]), np.ndarray, pw.this.x))}

    want = P.capture(pj, program(pj, lambda v: np.asarray(v, np.float32)))
    got = P.capture(pt, program(pt, lambda v: torch.tensor(v, dtype=torch.float32)))
    assert got == want and len(got["v"]) == 3


def test_bf16_udf_results_keep_their_dtype():
    """A UDF returning a bf16 ``torch.Tensor`` gives the column JAX's bf16
    numpy array (``ml_dtypes.bfloat16``, the same bits) for the same values
    as a JAX bf16 array, on the pure-Python core as on the native one."""
    import jax.numpy as jnp
    import torch

    def program(pw, full, dtype):
        t = pw.debug.table_from_markdown("x\n1\n2\n7")

        @pw.udf
        def emb(x: int):
            return full((3,), float(x) + 0.3, dtype=dtype)

        return {"v": t.select(v=emb(pw.this.x))}

    want = P.capture(pj, program(pj, jnp.full, jnp.bfloat16))
    got = P.capture(pt, program(pt, torch.full, torch.bfloat16))
    assert got == want and len(got["v"]) == 3
    assert {row[1][0][1] for _t, _k, _d, row in got["v"]} == {"bfloat16"}
    script = ("import sys, pickle, torch, pathway_tpu_torch as pw\n"
              "from tests import torch_dataflow_programs as P\n"
              "t = pw.debug.table_from_markdown('x\\n1\\n2\\n7')\n"
              "@pw.udf\ndef emb(x: int):\n    return torch.full((3,), float(x) + 0.3, dtype=torch.bfloat16)\n"
              "sys.stdout.buffer.write(pickle.dumps(P.capture(pw, {'v': t.select(v=emb(pw.this.x))})))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, cwd=REPO, timeout=120,
                          env={**os.environ, "PATHWAY_NATIVE": "0"})
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    import pickle

    assert pickle.loads(proc.stdout) == want


def test_concurrent_first_builds_both_load(build_race):
    """Two processes build the native core into one empty directory at once:
    both load the one build, neither falls back to Python, and no
    temporary file is left behind."""
    build, procs = build_race
    results = [p.communicate(timeout=180) for p in procs]
    for proc, (_out, err) in zip(procs, results):
        assert proc.returncode == 0, err[-3000:]
        assert "Python fallbacks" not in err, err[-3000:]
    built = sorted(os.listdir(build))
    assert len([f for f in built if f.endswith(".so")]) == 1, built
    assert not [f for f in built if f.endswith(".tmp")], built


def test_run_refuses_what_later_slices_bring(monkeypatch, tmp_path):
    """H5 and H6 features raise naming their slice.  Several processes and
    warm standbys came with slice H4b: ``PATHWAY_PROCESSES=2`` runs a
    2-worker mesh to the JAX package's net output, and
    ``PATHWAY_STANDBY_ID`` on a run with no root to tail refuses as the JAX
    package does."""
    from tests import torch_cluster_programs as cluster

    nets = []
    for pkg in cluster.PACKAGES:
        (tmp_path / pkg).mkdir()
        cluster.run_cluster(pkg, "wordcount", tmp_path / pkg, n=2)
        nets.append(cluster.canonical_bytes(tmp_path / pkg, "out.jsonl"))
    assert nets[0] == nets[1] != b"[]"
    t = pt.debug.table_from_markdown("v\n1")
    t._subscribe_raw(lambda *a: None)
    try:
        for kwargs, slice_ in ((dict(with_http_server=True), "H5"),
                               (dict(monitoring_level=pt.MonitoringLevel.ALL), "H5")):
            with pytest.raises(NotImplementedError, match=slice_):
                pt.run(**kwargs)
        monkeypatch.setenv("PATHWAY_STANDBY_ID", "2")
        for pw in (pj, pt):
            with pytest.raises(RuntimeError, match="requires a filesystem persistence root"):
                pw.run()
        monkeypatch.delenv("PATHWAY_STANDBY_ID")
        with pytest.raises(NotImplementedError, match="H6"):
            t.live()
        with pytest.raises(NotImplementedError, match="H6"):
            pt.run(persistence_config=pt.persistence.Config(pt.persistence.Backend.s3("s3://b/p")))
        assert pt.run(monitoring_level=pt.MonitoringLevel.NONE).epochs == 1
    finally:
        pt.G.clear()
