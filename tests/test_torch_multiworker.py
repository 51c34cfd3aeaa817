"""The port's multi-worker SPMD runs against the JAX package's.

The scenarios of ``tests/test_multiworker.py``: N forked processes form
one localhost TCP mesh, run the same program and write per-worker
``.part-N`` shards.  Each program runs in both packages at 2 workers, and
the port's net output must equal the JAX package's byte for byte, and the
single-process run's (``tests/torch_cluster_programs.py``).
"""

from __future__ import annotations

import json
import os
import threading

import pytest

import pathway_tpu  # noqa: F401 - imported once here, inherited by every forked child
import pathway_tpu_torch  # noqa: F401
from tests import torch_cluster_programs as progs

N = 2


def cluster_bytes(pkg: str, program: str, tmpdir) -> bytes:
    progs.run_cluster(pkg, program, tmpdir, n=N)
    return progs.canonical_bytes(tmpdir, "out.jsonl")


@pytest.mark.parametrize("program", ["wordcount", "join_groupby", "global_sort", "knn_retrieval", "bf16_vectors"])
def test_cluster_net_output_equals_jax_and_single_process(tmp_path, program):
    single = tmp_path / "single"
    single.mkdir()
    progs.run_single("pathway_tpu_torch", program, single)
    expected = progs.canonical_bytes(single, "out.jsonl")
    assert expected != b"[]"
    got = {}
    for pkg in progs.PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = cluster_bytes(pkg, program, d)
    if program == "bf16_vectors":
        # the port keeps the dtype across the mesh; the JAX package's codec
        # reads its void bytes back (ROADMAP Queue 3): the same bits in both
        dtypes = {pkg: {json.loads(k)["v"].split(":")[0] for k, _ in json.loads(net)} for pkg, net in got.items()}
        assert dtypes["pathway_tpu_torch"] == {"bfloat16"} and "|V2" in dtypes["pathway_tpu"]
        got["pathway_tpu"] = got["pathway_tpu"].replace(b"|V2:", b"bfloat16:")
    assert got["pathway_tpu_torch"] == got["pathway_tpu"] == expected
    if program == "global_sort":
        pairs = sorted((json.loads(k)["v"], json.loads(k)["prev_v"]) for k, _ in json.loads(expected))
        assert pairs == [(5, None), (10, 5), (20, 10), (30, 20), (40, 30), (45, 40), (50, 45), (60, 50)]


def test_fs_sources_stripe_files_across_workers(tmp_path):
    """Each file belongs to one worker (a stable hash of its path): every
    line is read exactly once cluster-wide, in both packages, and both
    workers read some files."""
    all_lines = []
    got = {}
    for pkg in progs.PACKAGES:
        d = tmp_path / pkg
        (d / "data").mkdir(parents=True)
        for i in range(7):
            lines = [f"file{i}-line{j}" for j in range(5)]
            if pkg == "pathway_tpu":
                all_lines.extend(lines)
            (d / "data" / f"f{i}.txt").write_text("\n".join(lines) + "\n")
        got[pkg] = cluster_bytes(pkg, "fs_lines", d)
        assert (d / "out.jsonl.part-1").stat().st_size > 0
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert sorted(json.loads(k)["data"] for k, _ in json.loads(got["pathway_tpu"])) == sorted(all_lines)


def test_peer_hosts_mesh_on_localhost():
    """Explicit per-worker hostnames (``PATHWAY_PEER_HOSTS``, the mode k8s
    pods use), all localhost: gather and broadcast agree."""
    from pathway_tpu_torch.engine.comm import TcpMesh

    port = progs.free_port_base(3)
    hosts = ["127.0.0.1", "localhost", "127.0.0.1"]
    results = {}

    def worker(wid):
        mesh = TcpMesh(wid, 3, port, peer_hosts=hosts).start()
        try:
            got = mesh.gather(("t", 1), wid * 10)
            if wid == 0:
                results["gathered"] = got
            results[wid] = mesh.bcast(("b", 1), sum(got) if wid == 0 else None)
        finally:
            mesh.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results["gathered"] == [0, 10, 20]
    assert results[0] == results[1] == results[2] == 30


def test_persisted_cluster_resumes_with_new_input(tmp_path):
    """Worker-sharded snapshots (one metadata shard per worker), then a
    resumed cluster run with one more file: net output exactly once, as
    the JAX package's."""
    got = {}
    for pkg in progs.PACKAGES:
        d = tmp_path / pkg
        (d / "pin").mkdir(parents=True)
        (d / "pin" / "a.csv").write_text("word\nfoo\nbar\nfoo\n")
        first = cluster_bytes(pkg, "persisted_wordcount", d)
        metas = [f for f in os.listdir(d / "pstore") if f.startswith("metadata.json")]
        assert len(metas) == N, metas
        for name in ("out.jsonl", "out.jsonl.part-1"):
            if (d / name).exists():
                (d / name).unlink()
        (d / "pin" / "b.csv").write_text("word\nfoo\nbaz\n")
        got[pkg] = (first, cluster_bytes(pkg, "persisted_wordcount", d))
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    first, second = got["pathway_tpu_torch"]
    assert {json.loads(k)["word"]: json.loads(k)["n"] for k, _ in json.loads(first)} == {"foo": 2, "bar": 1}
    assert {json.loads(k)["word"]: json.loads(k)["n"] for k, _ in json.loads(second)} == {
        "foo": 3, "bar": 1, "baz": 1,
    }



def test_debug_tables_are_built_on_every_worker_like_jax(tmp_path):
    """A ``pw.debug`` table has no shard filter: each worker builds it
    whole, so a 2-worker groupby over one counts every row twice, in both
    packages (ROADMAP Queue 3; ``make_static_input_table`` keeps a shard a
    worker)."""
    single = tmp_path / "single"
    single.mkdir()
    progs.run_single("pathway_tpu_torch", "markdown_sums", single)
    once = {json.loads(k)["a"]: json.loads(k)["s"] for k, _ in json.loads(progs.canonical_bytes(single, "out.jsonl"))}
    got = {}
    for pkg in progs.PACKAGES:
        (tmp_path / pkg).mkdir()
        got[pkg] = cluster_bytes(pkg, "markdown_sums", tmp_path / pkg)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    twice = {json.loads(k)["a"]: json.loads(k)["s"] for k, _ in json.loads(got["pathway_tpu"])}
    assert twice == {a: 2 * s for a, s in once.items()}
