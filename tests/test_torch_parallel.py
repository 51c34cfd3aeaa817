"""The port's device mesh, DTensor sharding, sharded top-k and sharded
indexes across gloo ranks, against the JAX package on a mesh of the same
size (the conftest's virtual CPU devices) and against the port's own
single-device path.

Each world size spawns one gloo group (``tests/gloo_ranks.py``) that runs
every case; each test asserts on its own case.  Scores are f32 on the CPU
in both packages: ids equal, scores within ``SCORE_TOL`` of JAX's (as
``tests/test_torch_topk.py`` holds the single-device path) and within
``SINGLE_TOL`` of the port's own single-device answers (the same f32
arithmetic, row by row).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from torch.multiprocessing import ProcessRaisedException  # noqa: E402
from torch.multiprocessing.spawn import ProcessException  # noqa: E402

from pathway_tpu.ops import topk as jtopk  # noqa: E402
from pathway_tpu.parallel import ShardedDeviceIndex as JaxShardedIndex  # noqa: E402
from pathway_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from pathway_tpu.parallel import mesh_shape_for as jax_mesh_shape_for  # noqa: E402
from pathway_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from pathway_tpu.parallel import sharded_topk as jax_sharded_topk  # noqa: E402
from pathway_tpu.stdlib.indexing import nearest_neighbors as jnn  # noqa: E402
from pathway_tpu_torch.ops import topk as ttopk  # noqa: E402
from pathway_tpu_torch.parallel import ShardedDeviceIndex, initialize_distributed, mesh_shape_for  # noqa: E402
from pathway_tpu_torch.parallel.mesh import resolve_coordinator  # noqa: E402
from tests import gloo_ranks as g  # noqa: E402

SCORE_TOL = 1e-4  # tests/test_torch_topk.py's, f32 on the CPU in both packages
SINGLE_TOL = 1e-5  # the port's own single-device path: same f32 arithmetic per row
BF16_TOL = 0.02  # tests/test_sharded_retrieval.py:257, bf16 storage
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    return request.param


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {w: g.RankGroup(g.parallel_cases, w, tmp_path_factory.mktemp(f"parallel{w}")) for w in WORLDS}
    yield started
    for group in started.values():
        group.stop()


@pytest.fixture(scope="module")
def ranks(world, groups):
    return groups[world].results()


@pytest.fixture(scope="module")
def jmesh(world):
    return jax_make_mesh(world)


def _rows(mesh):
    return NamedSharding(mesh, P(tuple(mesh.axis_names), None))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8, 16])
@pytest.mark.parametrize("max_model", [1, 2, 4])
def test_mesh_shape_for_matches_jax(n, max_model):
    assert mesh_shape_for(n, max_model) == jax_mesh_shape_for(n, max_model)
    assert mesh_shape_for(8) == (4, 2) and mesh_shape_for(7) == (7, 1)  # tests/test_parallel.py:23-27


def test_make_mesh_axes_and_shape(ranks, world, jmesh):
    for rank, res in enumerate(ranks):
        m = res["mesh"]
        assert m["names"] == m["flat_axes"] == ("data", "model") == jmesh.axis_names
        assert m["shape"] == tuple(jmesh.shape[a] for a in jmesh.axis_names) == mesh_shape_for(world)
        # one rank per device, data-major as JAX's _flat_axis_index
        assert m["flat_rank"] == rank
        assert m["coordinate"] == (rank // m["shape"][1], rank % m["shape"][1])
        assert "world of" in m["more_than_world"]


def test_shard_params_placements_match_jax(ranks, jmesh):
    tree = g.encoder_tree()
    placed = jax_shard_params(tree, jmesh)
    model_dim = jmesh.axis_names.index("model")
    leaves = list(g._leaves(placed))
    assert len(leaves) == len(ranks[0]["params"])
    sharded = 0
    for path, leaf in leaves:
        spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
        jax_dim = spec.index("model") if "model" in spec else None
        for res in ranks:
            got = res["params"]["/".join(path)]
            want = ["R"] * len(jmesh.axis_names)
            shape = list(leaf.shape)
            if jax_dim is not None:
                want[model_dim] = f"S({jax_dim})"
                shape[jax_dim] //= jmesh.shape["model"]
            assert got["placements"] == tuple(want), path
            assert got["local_shape"] == tuple(shape), path
            assert got["equal"], path  # the tree reassembles bit-equal
        sharded += jax_dim is not None
    assert 0 < sharded < len(leaves)  # both rules and the replicated leaves are exercised


def test_shard_batch_and_put_global(ranks, world):
    data = ranks[0]["mesh"]["shape"][0]
    rows = np.arange(world * 3 * 2, dtype=np.float32).reshape(world * 3, 2)
    ids = np.arange(8 * 3).reshape(8, 3)
    for rank, res in enumerate(ranks):
        d = res["mesh"]["coordinate"][0]
        placements, local = res["batch"]["ids"]
        assert placements == ("S(0)", "R")
        per = 8 // data
        np.testing.assert_array_equal(local, ids[d * per : (d + 1) * per])
        assert res["batch"]["mask"][1].shape == (per, 3)
        np.testing.assert_array_equal(res["put_global_rows"], rows[rank * 3 : (rank + 1) * 3])


@pytest.mark.parametrize("k", [3, g.K_BIG])  # K_BIG is more than a shard's rows at worlds 2 and 4
@pytest.mark.parametrize("metric", g.METRICS)
def test_sharded_topk_matches_jax(ranks, jmesh, metric, k):
    docs, queries = g.index_data(g.TOPK_ROWS)
    mask = np.zeros(g.TOPK_ROWS, np.float32)
    mask[-3:] = -np.inf
    jdocs = jax.device_put(docs, _rows(jmesh))
    jmask = jax.device_put(mask, NamedSharding(jmesh, P(tuple(jmesh.axis_names))))
    jidx, jvals = jax_sharded_topk(jmesh, jdocs, jmask, jnp.asarray(queries), k, metric)
    single_vals, single_idx = ttopk.masked_topk_block(
        torch.from_numpy(docs), torch.from_numpy(mask), torch.from_numpy(queries), metric=metric, k=k
    )
    for res in ranks:
        idx, vals = res["sharded_topk"][metric, k]
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_allclose(vals, np.asarray(jvals), atol=SCORE_TOL, rtol=0)
        np.testing.assert_array_equal(idx, single_idx.numpy())
        np.testing.assert_allclose(vals, single_vals.numpy(), atol=SINGLE_TOL, rtol=0)
        assert np.isfinite(vals).all() and (idx < g.TOPK_ROWS - 3).all()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sharded_index_matches_jax(ranks, jmesh, name):
    dtype = ml_dtypes.bfloat16 if name == "bf16" else None
    first = g.unit_rows(g.INDEX_ROWS[0], seed=1)
    second = g.unit_rows(g.INDEX_ROWS[1], seed=2)
    index = JaxShardedIndex(jmesh, first.shape[1], block=g.INDEX_BLOCK, dtype=dtype)
    index.add(first)
    probe = first[[0, 7, 23]] + 0.01
    want = [index.search(probe, 5)]
    cap = index._docs.shape[0]
    index.add(second)
    want.append(index.search(np.concatenate([probe, second[:2]]), 5))
    world = len(ranks)
    for res in ranks:
        got = res["index"][name]
        assert got["empty"] == ((2, 0), (2, 0))
        assert got["n"] == sum(g.INDEX_ROWS)
        # capacity in multiples of n_ranks x block; growth within it keeps the shape
        assert got["capacities"] == (cap, index._docs.shape[0]) == (cap, cap)
        assert got["local_rows"] == cap // world
        assert got["dtype"] == ("torch.bfloat16" if name == "bf16" else "torch.float32")
        for (idx, vals), (jidx, jvals) in zip(got["results"], want):
            if name == "f32":
                np.testing.assert_array_equal(idx, jidx)
                np.testing.assert_allclose(vals, jvals, atol=SCORE_TOL, rtol=0)
            else:
                np.testing.assert_array_equal(idx[:, 0], jidx[:, 0])
                np.testing.assert_allclose(vals[:, 0], jvals[:, 0], atol=BF16_TOL, rtol=0)
        planted = [0, 7, 23, g.INDEX_ROWS[0], g.INDEX_ROWS[0] + 1]
        assert got["results"][1][0][:, 0].tolist() == planted


@pytest.mark.parametrize("metric", g.METRICS)
@pytest.mark.parametrize("n", g.CACHE_SIZES)
def test_mesh_cache_matches_single_device_and_jax(ranks, jmesh, n, metric):
    matrix, qs = g.index_data(n, q=7)
    jcache = jtopk.DeviceIndexCache(mesh=jmesh)
    jidx, jvals = jtopk.topk_search_cached(matrix, qs, 5, metric, cache=jcache, version=1)
    jpadded, jmask, _ = jcache.get(matrix, 1, metric)
    world = len(ranks)
    for rank, res in enumerate(ranks):
        got = res["cache"][n, metric]
        idx, vals = got["mesh"]
        sidx, svals = got["single"]
        np.testing.assert_array_equal(idx, sidx)  # the port's own single-device answer
        np.testing.assert_allclose(vals, svals, atol=SINGLE_TOL, rtol=0)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(vals, jvals, atol=SCORE_TOL, rtol=0)
        # capacity: next power of two, a multiple of the rank count; this
        # rank's slice of JAX's padding mask
        assert got["capacity"] == jpadded.shape[0] and got["local"] * world == got["capacity"]
        per = got["local"]
        np.testing.assert_array_equal(got["mask"], np.asarray(jmask)[rank * per : (rank + 1) * per])


def test_mesh_cache_growth_at_warm_capacity(ranks):
    for res in ranks:
        got = res["cache_growth"]
        assert got["capacities"][0] == got["capacities"][1]
        for row, planted in zip(got["idx"], range(300, got["n"])):
            assert planted in row.tolist()


@pytest.mark.parametrize("metric", g.METRICS)
def test_brute_force_index_on_a_mesh(ranks, jmesh, metric):
    matrix, _ = g.index_data(g.KNN_ROWS, seed=5)
    j = jnn.BruteForceKnnIndex(jnn.DistanceMetric(metric), mesh=jmesh)
    for i, vec in enumerate(matrix):
        j.add(1000 + i, vec, g.knn_meta(i))
    want = j.search_many(g.knn_requests(matrix.shape[1]))
    for res in ranks:
        on_mesh, single = res["knn"][metric]
        for got, ref, jref in zip(on_mesh, single, want):
            assert [key for key, _ in got] == [key for key, _ in ref] == [key for key, _ in jref]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=SINGLE_TOL, rtol=0)
            np.testing.assert_allclose([s for _, s in got], [s for _, s in jref], atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("n", [1, 1023, 1024, 100_000, 10_000_000])
def test_capacity_model_matches_jax(n):
    """tests/test_sharded_retrieval.py:211-236's layout: capacity in
    multiples of n_chips × block, equal slices per card."""
    ours = ShardedDeviceIndex.__new__(ShardedDeviceIndex)
    theirs = JaxShardedIndex.__new__(JaxShardedIndex)
    for ix in (ours, theirs):
        ix.n_chips, ix.block = 16, 1024
    cap = ours._capacity(n)
    assert cap == theirs._capacity(n) and cap >= n and cap % (16 * 1024) == 0
    if n == 10_000_000:
        assert cap // 16 == 625_664  # ceil(10M/16) rounded to the 1024 block


def test_initialize_distributed_is_a_no_op_at_one_process(monkeypatch):
    monkeypatch.delenv("PATHWAY_PROCESSES", raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_coordinator_resolution(monkeypatch):
    """Argument, then PATHWAY_DEVICE_COORDINATOR, then the first peer host
    at first_port + 1000 + the restart attempt (pathway_tpu/parallel/mesh.py:47-64)."""
    monkeypatch.delenv("PATHWAY_DEVICE_COORDINATOR", raising=False)
    monkeypatch.delenv("PATHWAY_PEER_HOSTS", raising=False)
    monkeypatch.delenv("PATHWAY_FIRST_PORT", raising=False)
    monkeypatch.delenv("PATHWAY_RESTART_ATTEMPT", raising=False)
    assert resolve_coordinator() == "tcp://127.0.0.1:11000"
    monkeypatch.setenv("PATHWAY_PEER_HOSTS", "pod-0.svc, pod-1.svc")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "20000")
    monkeypatch.setenv("PATHWAY_RESTART_ATTEMPT", "3")
    assert resolve_coordinator() == "tcp://pod-0.svc:21003"
    monkeypatch.setenv("PATHWAY_DEVICE_COORDINATOR", "coord:7000")
    assert resolve_coordinator() == "tcp://coord:7000"
    assert resolve_coordinator("file:///tmp/store") == "file:///tmp/store"


# a rank that dies may be seen first as its own exit or as the peer's
# collective failing on the closed connection: either fails the wait
FAILURES = {"raises": ProcessRaisedException, "dies": ProcessException, "wedges": TimeoutError}


@pytest.fixture(scope="module")
def failed_groups(tmp_path_factory):
    started = {
        name: g.RankGroup(
            getattr(g, f"rank_{name}"), 2, tmp_path_factory.mktemp(name),
            deadline_s=g.FAIL_DEADLINE_S if name == "wedges" else g.DEADLINE_S,
        )
        for name in FAILURES
    }
    yield started
    for group in started.values():
        group.stop()


@pytest.mark.parametrize("name", list(FAILURES))
def test_a_failed_rank_fails_within_the_deadline(failed_groups, name):
    """Rank 1 raises, exits or hangs while rank 0 waits in a collective:
    the wait fails within its deadline and leaves no rank running."""
    group = failed_groups[name]
    with pytest.raises(FAILURES[name]):
        group.results()
    assert time.monotonic() < group._end + 15
    assert not any(proc.is_alive() for proc in group._ctx.processes)
    assert not os.path.exists(os.path.join(group.tmp, "result_0.pkl"))
