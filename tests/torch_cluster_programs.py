"""Cluster programs shared by the port's multi-worker tests.

Each program is the JAX package's own test scenario
(``tests/test_multiworker.py``, ``test_supervised_recovery.py``,
``test_standby_promotion.py``) written against a package name —
``pathway_tpu`` or ``pathway_tpu_torch`` — so one test runs it in both and
holds the port's net output to the JAX package's, byte for byte
(:func:`canonical_bytes`: rows net of retractions across every worker's
``.part-N`` shard, sorted, epoch times left out).

Workers are forked children (``multiprocessing.get_context("fork")``) of
the test process, which imports both packages once; a child sets the
worker env, re-reads the config and the fault plan, and builds the
program.  :func:`run_cluster` starts an unsupervised mesh,
:func:`run_supervised` hands the same spawn function to the package's
``Supervisor``.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing
import os
import signal
import socket
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
N_ROWS = 45
ROW_DELAY_S = 0.03
EXPECTED_COUNTS = {0: 15, 1: 15, 2: 15}
WORDS = (
    "alpha beta gamma alpha delta beta alpha epsilon gamma beta "
    "zeta eta theta alpha beta gamma delta delta epsilon zeta eta"
).split()


def free_port_base(n: int) -> int:
    """The first of ``n`` consecutive free localhost ports (best effort)."""
    socks = []
    try:
        base = None
        for _ in range(20):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        ports = sorted(s.getsockname()[1] for s in socks)
        for i in range(len(ports) - n):
            if ports[i + n - 1] - ports[i] == n - 1:
                base = ports[i]
                break
        return base or ports[0]
    finally:
        for s in socks:
            s.close()


def canonical_bytes(tmpdir, name: str = "counts.jsonl", workers: int = 4) -> bytes:
    """Canonical serialized net output across all worker sink shards."""
    state: Counter = Counter()
    base = Path(tmpdir) / name
    for path in [base] + [Path(f"{base}.part-{w}") for w in range(1, workers + 1)]:
        if not path.exists():
            continue
        for line in path.read_text().splitlines():
            obj = json.loads(line)
            diff = obj.pop("diff")
            obj.pop("time")
            state[json.dumps(obj, sort_keys=True)] += diff
    assert all(c >= 0 for c in state.values()), state
    return json.dumps(sorted((k, c) for k, c in state.items() if c)).encode()


def counts_of(blob: bytes) -> dict:
    """``{k: n}`` of a canonical groupby-count output."""
    return {json.loads(k)["k"]: json.loads(k)["n"] for k, _c in json.loads(blob.decode())}


# ---------------------------------------------------------------------------
# Programs: pw is the package module, tmpdir the run's directory
# ---------------------------------------------------------------------------


def _persistence(pw, tmpdir, interval_ms=50):
    return pw.persistence.Config(
        pw.persistence.Backend.filesystem(os.path.join(tmpdir, "pstore")),
        snapshot_interval_ms=interval_ms,
    )


def streaming_counts(pw, tmpdir, gated: bool = False, out_name: str = "counts.jsonl"):
    """A Python subject of ``N_ROWS`` rows, one commit each, grouped by key
    into a jsonlines sink, persisted every 50 ms.  ``gated``: rows 10+ wait
    for one committed generation on worker 0 and rows 20+ for two, so a
    crash past them lands after real commits whatever the pace."""
    manifest_dir = os.path.join(tmpdir, "pstore", "manifests", "0")

    def wait_for_generations(n):
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                if len([f for f in os.listdir(manifest_dir) if not f.endswith(".tmp")]) >= n:
                    return
            except OSError:
                pass
            time.sleep(0.01)
        raise RuntimeError(f"gated source: generation {n} never appeared")

    class Src(pw.io.python.ConnectorSubject):
        def run(self):
            for i in range(N_ROWS):
                if gated and i in (10, 20):
                    wait_for_generations(i // 10)
                self.next(k=i % 3, v=1)
                self.commit()
                time.sleep(ROW_DELAY_S)

    t = pw.io.python.read(Src(), schema=pw.schema_from_types(k=int, v=int), name="src")
    counts = t.groupby(t.k).reduce(k=t.k, n=pw.reducers.count())
    pw.io.jsonlines.write(counts, os.path.join(tmpdir, out_name))
    pw.run(persistence_config=_persistence(pw, tmpdir))


def wordcount(pw, tmpdir):
    from_static = importlib.import_module(f"{pw.__name__}.io._utils").make_static_input_table
    words = from_static(pw.schema_from_types(word=str), [{"word": w} for w in WORDS])
    counts = words.groupby(pw.this.word).reduce(word=pw.this.word, count=pw.reducers.count())
    pw.io.jsonlines.write(counts, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def join_groupby(pw, tmpdir):
    from_static = importlib.import_module(f"{pw.__name__}.io._utils").make_static_input_table
    orders = from_static(
        pw.schema_from_types(cust=str, amount=int),
        [{"cust": c, "amount": a} for c, a in [
            ("ann", 10), ("bob", 20), ("ann", 5), ("cid", 7),
            ("bob", 1), ("dee", 90), ("ann", 2), ("eve", 4),
        ]],
    )
    tiers = from_static(
        pw.schema_from_types(cust=str, tier=str),
        [{"cust": c, "tier": t} for c, t in [
            ("ann", "gold"), ("bob", "silver"), ("cid", "bronze"),
            ("dee", "gold"), ("eve", "silver"),
        ]],
    )
    joined = orders.join(tiers, pw.left.cust == pw.right.cust).select(
        cust=pw.left.cust, amount=pw.left.amount, tier=pw.right.tier
    )
    totals = joined.groupby(pw.this.tier).reduce(
        tier=pw.this.tier, total=pw.reducers.sum(pw.this.amount)
    )
    pw.io.jsonlines.write(totals, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def fs_lines(pw, tmpdir):
    lines = pw.io.plaintext.read(os.path.join(tmpdir, "data"), mode="static")
    pw.io.jsonlines.write(lines, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def persisted_wordcount(pw, tmpdir):
    t = pw.io.csv.read(
        os.path.join(tmpdir, "pin"), schema=pw.schema_from_types(word=str),
        mode="static", name="pwords",
    )
    counts = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
    pw.io.jsonlines.write(counts, os.path.join(tmpdir, "out.jsonl"))
    pw.run(persistence_config=_persistence(pw, tmpdir, interval_ms=0))


def global_sort(pw, tmpdir):
    from_static = importlib.import_module(f"{pw.__name__}.io._utils").make_static_input_table
    t = from_static(pw.schema_from_types(v=int), [{"v": v} for v in [30, 10, 50, 20, 40, 60, 5, 45]])
    s = t.sort(key=pw.this.v)
    res = t.with_columns(prev_v=t.ix(s.prev, optional=True).v)
    pw.io.jsonlines.write(res, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def knn_retrieval(pw, tmpdir):
    from_static = importlib.import_module(f"{pw.__name__}.io._utils").make_static_input_table
    indexing = importlib.import_module(f"{pw.__name__}.stdlib.indexing")
    mocks = importlib.import_module(f"{pw.__name__}.xpacks.llm.mocks")
    docs = from_static(
        pw.schema_from_types(text=str),
        [{"text": t} for t in [
            "alpha beta", "gamma delta", "epsilon zeta", "eta theta", "iota kappa", "lambda mu",
        ]],
    )
    queries = from_static(
        pw.schema_from_types(q=str), [{"q": q} for q in ["alpha beta", "eta theta", "lambda mu"]]
    )
    kwargs = {"device": "cpu"} if pw.__name__ == "pathway_tpu_torch" else {}
    index = indexing.default_brute_force_knn_document_index(
        docs.text, docs, embedder=mocks.FakeEmbeddings(), dimensions=16, **kwargs
    )
    res = index.query_as_of_now(queries.q, number_of_matches=1).select(
        q=queries.q, match=pw.this.text
    )
    pw.io.jsonlines.write(res, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def bf16_vectors(pw, tmpdir):
    """A UDF's bf16 vectors (a torch tensor in the port, an ``ml_dtypes``
    array in the JAX package: a forked child must not run XLA, whose
    threads stayed in the parent) joined by another key than their rows',
    so they cross the mesh; the sink writes each vector's dtype and bytes."""
    from_static = importlib.import_module(f"{pw.__name__}.io._utils").make_static_input_table
    if pw.__name__ == "pathway_tpu_torch":
        import torch

        def make(x):
            return torch.arange(4, dtype=torch.float32).mul(0.37).add(x).to(torch.bfloat16)
    else:
        import ml_dtypes
        import numpy as np

        def make(x):
            return (np.arange(4, dtype=np.float32) * np.float32(0.37) + np.float32(x)).astype(ml_dtypes.bfloat16)

    @pw.udf
    def emb(x: int):
        return make(float(x))

    docs = from_static(pw.schema_from_types(doc=int, group=int),
                       [{"doc": i, "group": i % 3} for i in range(12)])
    groups = from_static(pw.schema_from_types(group=int, label=str),
                         [{"group": g, "label": f"g{g}"} for g in range(3)])
    vecs = docs.select(pw.this.doc, pw.this.group, v=emb(pw.this.doc))
    joined = vecs.join(groups, pw.left.group == pw.right.group).select(
        doc=pw.left.doc, label=pw.right.label, v=pw.left.v
    )
    out = joined.select(pw.this.doc, pw.this.label, v=pw.apply_with_type(
        lambda v: f"{v.dtype}:{v.tobytes().hex()}", str, pw.this.v
    ))
    pw.io.jsonlines.write(out, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


def markdown_sums(pw, tmpdir):
    """A groupby over ``pw.debug.table_from_markdown``: a debug table is
    built whole on every worker, in both packages."""
    t = pw.debug.table_from_markdown("a | b\n1 | 2\n3 | 4\n1 | 5\n7 | 1")
    res = t.groupby(pw.this.a).reduce(a=pw.this.a, s=pw.reducers.sum(pw.this.b))
    pw.io.jsonlines.write(res, os.path.join(tmpdir, "out.jsonl"))
    pw.run()


PROGRAMS = {
    f.__name__: f
    for f in (streaming_counts, wordcount, join_groupby, fs_lines, persisted_wordcount,
              global_sort, knn_retrieval, bf16_vectors, markdown_sums)
}


# ---------------------------------------------------------------------------
# Workers and clusters
# ---------------------------------------------------------------------------


def worker_main(pkg, wid, attempt, n, port, tmpdir, plan_json, program, kwargs, errq=None):
    """One forked worker: set the env, re-read config and plan, run."""
    try:
        os.environ.update(
            PATHWAY_PROCESSES=str(n), PATHWAY_PROCESS_ID=str(wid),
            PATHWAY_FIRST_PORT=str(port), PATHWAY_THREADS="1",
            PATHWAY_COMM_SECRET="chaos-test", PATHWAY_RESTART_ATTEMPT=str(attempt),
            PATHWAY_COMM_HEARTBEAT_S="0.5", PATHWAY_COMM_RECONNECT_WINDOW_S="5",
        )
        if plan_json:
            os.environ["PATHWAY_FAULT_PLAN"] = plan_json
        else:
            os.environ.pop("PATHWAY_FAULT_PLAN", None)
        pw = importlib.import_module(pkg)
        importlib.import_module(f"{pkg}.internals.config").refresh_config()
        importlib.import_module(f"{pkg}.engine.faults").clear_plan()
        importlib.import_module(f"{pkg}.internals.parse_graph").G.clear()
        PROGRAMS[program](pw, tmpdir, **kwargs)
        if errq is not None:
            errq.put((wid, None))
    except Exception:
        if errq is None:
            raise
        errq.put((wid, traceback.format_exc()))
        sys.exit(1)


def run_single(pkg, program, tmpdir, **kwargs):
    """The program in this process, one worker: the ground truth."""
    for var in ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_FIRST_PORT"):
        os.environ.pop(var, None)
    pw = importlib.import_module(pkg)
    importlib.import_module(f"{pkg}.internals.config").refresh_config()
    G = importlib.import_module(f"{pkg}.internals.parse_graph").G
    G.clear()
    try:
        PROGRAMS[program](pw, str(tmpdir), **kwargs)
    finally:
        G.clear()


def run_cluster(pkg, program, tmpdir, n=2, timeout=60, attempts=3, **kwargs):
    """An unsupervised mesh of ``n`` forked workers; a mesh-setup failure
    (a port taken between the probe and the bind) retries on fresh ports."""
    for attempt in range(1, attempts + 1):
        ctx = multiprocessing.get_context("fork")
        port = free_port_base(n)
        errq = ctx.Queue()
        procs = [
            ctx.Process(
                target=worker_main,
                args=(pkg, wid, 0, n, port, str(tmpdir), None, program, kwargs, errq),
            )
            for wid in range(n)
        ]
        for p in procs:
            p.start()
        failures = []
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                failures.append("timeout")
        while not errq.empty():
            wid, err = errq.get()
            if err is not None:
                failures.append(f"worker {wid}:\n{err}")
        if not failures:
            return
        mesh_setup = all(
            "CommError" in f or "Address already in use" in f or f == "timeout" for f in failures
        )
        if not mesh_setup or attempt == attempts:
            raise AssertionError("\n".join(failures))


def run_supervised(
    pkg, tmpdir, plan_json=None, *, n=2, max_restarts=3, standbys=0, shrink_on_loss=None,
    autoscale=None, procs=None, spawn_log=None, program="streaming_counts", **kwargs,
):
    """The program under ``pkg``'s ``Supervisor`` with forked workers."""
    supervisor = importlib.import_module(f"{pkg}.engine.supervisor")
    ctx = multiprocessing.get_context("fork")
    port = free_port_base(max(n, 2) + (standbys or 0))

    def spawn(wid: int, attempt: int, n_workers: int = n):
        if spawn_log is not None:
            spawn_log.append((attempt, wid))
        p = ctx.Process(
            target=worker_main,
            args=(pkg, wid, attempt, n_workers, port, str(tmpdir), plan_json, program, kwargs),
            daemon=True,
        )
        p.start()
        if procs is not None:
            procs[(attempt, wid)] = p
        return p

    return supervisor.Supervisor(
        spawn, n, max_restarts=max_restarts, restart_jitter_s=0.05,
        checkpoint_root=os.path.join(str(tmpdir), "pstore"),
        shrink_on_loss=shrink_on_loss, standbys=standbys, autoscale=autoscale,
    ).run()


def supervised_in_both(tmp_path, plan: dict | None, **kwargs) -> dict:
    """{package: (SupervisorResult, canonical net bytes, scrub report)} of
    one supervised run of ``streaming_counts`` in each package, after
    holding the port's net output to the JAX package's."""
    pz = importlib.import_module("pathway_tpu_torch.engine.persistence")
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        res = run_supervised(pkg, d, json.dumps(plan) if plan else None, **kwargs)
        report = pz.scrub_root(pz.FileBackend(str(d / "pstore")))
        out[pkg] = (res, canonical_bytes(d), report)
    assert out["pathway_tpu_torch"][1] == out["pathway_tpu"][1]
    assert counts_of(out["pathway_tpu_torch"][1]) == EXPECTED_COUNTS
    return out


def kill_worker_after_commits(tmpdir, procs, *, wid=1, min_gens=2):
    """SIGKILL the attempt-0 worker ``wid`` once worker 0 committed at
    least ``min_gens`` generations (``test_standby_promotion.py``)."""
    mdir = Path(tmpdir) / "pstore" / "manifests" / "0"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            if len([f for f in os.listdir(mdir) if not f.endswith(".tmp")]) >= min_gens:
                break
        except OSError:
            pass
        time.sleep(0.02)
    while time.monotonic() < deadline:
        p = procs.get((0, wid))
        if p is not None and p.pid:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            return
        time.sleep(0.02)
