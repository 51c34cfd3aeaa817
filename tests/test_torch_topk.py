"""The port's scoring, device index cache, top-k and brute-force index
against the JAX package's, both in f32 on the CPU.

Vectors come from numpy with a seed and have distinct scores, so the top-k
order is defined; ids must be equal and scores within 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pathway_tpu.ops import topk as jtopk  # noqa: E402
from pathway_tpu.stdlib.indexing import nearest_neighbors as jnn  # noqa: E402
from pathway_tpu_torch.ops import topk as ttopk  # noqa: E402
from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as tnn  # noqa: E402

METRICS = ["cos", "ip", "l2sq"]
SCORE_TOL = 1e-4


def _data(n, d=32, q=5, seed=0):
    rng = np.random.default_rng(seed)
    # small magnitudes keep l2sq scores O(1), where 1e-4 is f32-meaningful
    matrix = (rng.normal(size=(n, d)) * 0.2).astype(np.float32)
    queries = (rng.normal(size=(q, d)) * 0.2).astype(np.float32)
    return matrix, queries


@pytest.mark.parametrize("metric", METRICS)
def test_score_block_matches(metric):
    matrix, queries = _data(300)
    ref = np.asarray(jtopk.score_block(jax.numpy.asarray(matrix), jax.numpy.asarray(queries), metric))
    out = ttopk.score_block(torch.from_numpy(matrix), torch.from_numpy(queries), metric)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("n,cap", [(10, 256), (256, 256), (300, 512), (1025, 2048)])
@pytest.mark.parametrize("metric", METRICS)
def test_device_index_cache_capacity_and_mask(n, cap, metric):
    matrix, _ = _data(n)
    padded, mask, n_out = ttopk.DeviceIndexCache(device="cpu").get(matrix, 1, metric)
    jp, jm, jn_ = jtopk.DeviceIndexCache().get(matrix, 1, metric)
    assert n_out == jn_ == n
    assert tuple(padded.shape) == tuple(jp.shape) == (cap, matrix.shape[1])
    assert padded.dtype == torch.float32  # bf16 storage is for the card only
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert np.isneginf(mask.numpy()[n:]).all() and (mask.numpy()[:n] == 0).all()
    np.testing.assert_allclose(padded.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    assert (padded.numpy()[n:] == 0).all()


def test_device_index_cache_rebuilds_only_on_change():
    matrix, _ = _data(300)
    cache = ttopk.DeviceIndexCache(device="cpu")
    first = cache.get(matrix, 1, "ip")[0]
    assert cache.get(matrix, 1, "ip")[0] is first
    assert cache.get(matrix, 2, "ip")[0] is not first
    assert cache.get(matrix, 2, "cos")[0] is not first


def test_mesh_waits_for_the_multi_gpu_slice():
    with pytest.raises(NotImplementedError):
        ttopk.DeviceIndexCache(device="cpu", mesh=object())


@pytest.mark.parametrize("n", [100, 300, 1500])  # host path below 256 rows, device path above
@pytest.mark.parametrize("metric", METRICS)
def test_topk_search_cached_matches(n, metric):
    matrix, queries = _data(n, q=7)
    idx, vals = ttopk.topk_search_cached(
        matrix, queries, 5, metric, cache=ttopk.DeviceIndexCache(device="cpu"), version=1
    )
    jidx, jvals = jtopk.topk_search_cached(
        matrix, queries, 5, metric, cache=jtopk.DeviceIndexCache(), version=1
    )
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, atol=SCORE_TOL, rtol=0)


def test_topk_search_cached_splits_large_query_batches():
    """More queries than the largest bucket: the executor plans chunks."""
    matrix, queries = _data(400, q=700)
    cache = ttopk.DeviceIndexCache(device="cpu")
    idx, vals = ttopk.topk_search_cached(matrix, queries, 3, "ip", cache=cache, version=1)
    jidx, jvals = jtopk.topk_search_cached(matrix, queries, 3, "ip", cache=jtopk.DeviceIndexCache(), version=1)
    np.testing.assert_array_equal(idx, jidx)
    assert cache.executor.dispatches("indexing:masked_topk") == 2


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("metric", METRICS)
def test_topk_search_and_score_batch_match(n, metric):
    matrix, queries = _data(n, q=4, seed=1)
    idx, vals = ttopk.topk_search(matrix, queries, 4, metric, device="cpu")
    jidx, jvals = jtopk.topk_search(matrix, queries, 4, metric)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(
        ttopk.score_batch(matrix, queries, metric, device="cpu"),
        jtopk.score_batch(matrix, queries, metric),
        atol=SCORE_TOL,
        rtol=0,
    )


def _filled(n, metric, seed=2):
    matrix, _ = _data(n, seed=seed)
    t = tnn.BruteForceKnnIndex(tnn.DistanceMetric(metric), device="cpu")
    j = jnn.BruteForceKnnIndex(jnn.DistanceMetric(metric))
    for i, vec in enumerate(matrix):
        meta = {"owner": "kim" if i % 3 == 0 else "lee", "size": int(i)}
        t.add(1000 + i, vec, meta)
        j.add(1000 + i, vec, meta)
    return t, j, matrix


def _assert_same_hits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [key for key, _ in g] == [key for key, _ in r]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in r], atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("n", [120, 400])  # below and above the device threshold
@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_index_search_many_matches(n, metric):
    t, j, matrix = _filled(n, metric)
    rng = np.random.default_rng(9)
    queries = (rng.normal(size=(6, matrix.shape[1])) * 0.2).astype(np.float32)
    requests = [
        (queries[0], 5, None),
        (queries[1], None, None),  # default k
        (queries[2], 4, "owner == 'kim'"),
        (queries[3], 3, "owner == 'lee' && size > 50"),
        (list(queries[4]), 2, None),  # a plain list is a vector too
        (queries[5], 5, "globmatch('ki*', owner)"),
    ]
    _assert_same_hits(t.search_many(requests), j.search_many(requests))
    for key in range(1000, 1000 + n, 7):  # then remove some rows
        t.remove(key)
        j.remove(key)
    got = t.search_many(requests)
    _assert_same_hits(got, j.search_many(requests))
    assert all(key % 7 != 1000 % 7 for hits in got for key, _ in hits)
    _assert_same_hits([t.search(queries[0], 3)], [j.search(queries[0], 3)])


def test_brute_force_index_empty_and_device_default():
    t = tnn.BruteForceKnnIndex(tnn.DistanceMetric.COS, device="cpu")
    assert t.search_many([]) == []
    assert t.search(np.ones(4, np.float32), 3) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.BruteForceKnnIndex(tnn.DistanceMetric.COS)
