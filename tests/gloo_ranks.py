"""Gloo process groups for the port's multi-rank tests, and what their ranks run.

``run_ranks(fn, world, tmp)`` (or a :class:`RankGroup`, to run several
groups at once) spawns ``world`` processes, each joining one
gloo group through the port's ``initialize_distributed`` (rendezvous on a
``file://`` store under ``tmp``, never a fixed port, so pytest-xdist
workers cannot collide), runs ``fn(rank, world, *args)`` on every rank and
returns each rank's result.  The pytest process itself never joins a
group.  Every wait is bounded: the group's collectives time out after
``GROUP_TIMEOUT_S``, and ranks still alive at the deadline are killed and
the call raises ``TimeoutError``; a rank that raises or dies fails the
call at once (``torch.multiprocessing``'s ``ProcessRaisedException`` /
``ProcessExitedException``).

The rank bodies below import no JAX and nothing of ``pathway_tpu``, so a
spawned rank starts in seconds; the tests hold their results against the
JAX package in the parent process.  Each body runs every case of its test
file in one group, so a file spawns one group per world size, all at once.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60
DEADLINE_S = 120
METRICS = ("cos", "ip", "l2sq")


def _rank_main(rank: int, fn, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    sys.modules["transformers"] = None  # the hashing tokenizer and seeded weights, as on the card
    from pathway_tpu_torch.parallel.mesh import initialize_distributed

    store = f"file://{tmp}/store"
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    # initialize_distributed is a no-op at one process
    if not initialize_distributed(
        coordinator_address=store, num_processes=world, process_id=rank, device="cpu", timeout=timeout
    ):
        dist.init_process_group("gloo", init_method=store, world_size=1, rank=0, timeout=timeout)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


class RankGroup:
    """``fn(rank, world, *args)`` started now on each rank of a fresh gloo
    group of ``world`` processes; :meth:`results` waits for them (until the
    deadline, counted from the start) and returns their results in rank
    order.  Several groups may run at once."""

    def __init__(self, fn, world: int, tmp, *args, deadline_s: float = DEADLINE_S):
        self.name, self.world, self.tmp, self.deadline_s = fn.__name__, world, str(tmp), deadline_s
        self._end = time.monotonic() + deadline_s
        # the arguments go through a file: through the spawn pipe, more than
        # its 64 KiB buffer would make each rank wait for the one before it
        # to boot and read its copy
        with open(os.path.join(self.tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        self._ctx = mp.start_processes(
            _rank_main, args=(fn, world, self.tmp), nprocs=world, join=False, start_method="spawn"
        )
        self._results = None
        self._error = None

    def results(self) -> list:
        if self._error is not None:
            raise self._error
        if self._results is None:
            try:
                while not self._ctx.join(timeout=max(0.1, self._end - time.monotonic())):
                    if time.monotonic() >= self._end:
                        raise TimeoutError(
                            f"{self.world} gloo rank(s) of {self.name} still running after {self.deadline_s} s"
                        )
            except BaseException as e:
                self._error = e
                raise
            finally:
                self.stop()
            self._results = []
            for rank in range(self.world):
                with open(os.path.join(self.tmp, f"result_{rank}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def stop(self) -> None:
        """Kill any rank still running."""
        for proc in self._ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)


def run_ranks(fn, world: int, tmp, *args, deadline_s: float = DEADLINE_S) -> list:
    """:class:`RankGroup` started and waited for."""
    return RankGroup(fn, world, tmp, *args, deadline_s=deadline_s).results()


# Rank bodies that fail: rank 1 raises, exits or hangs while rank 0 waits
# for it in a collective.
FAIL_DEADLINE_S = 6  # the wedged rank's; the others fail at once


def rank_raises(rank: int, world: int):
    if rank == 1:
        raise RuntimeError("rank 1 failed")
    dist.barrier()


def rank_dies(rank: int, world: int):
    if rank == 1:
        os._exit(3)
    dist.barrier()


def rank_wedges(rank: int, world: int):
    if rank == 1:
        time.sleep(600)
    dist.barrier()


# ---------------------------------------------------------------------------
# Inputs, made the same way in the ranks and in the parent.
# ---------------------------------------------------------------------------


def index_data(n: int, d: int = 16, q: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    # small magnitudes keep l2sq scores O(1), where 1e-4 is f32-meaningful
    matrix = (rng.normal(size=(n, d)) * 0.2).astype(np.float32)
    queries = (rng.normal(size=(q, d)) * 0.2).astype(np.float32)
    return matrix, queries


def unit_rows(n: int, d: int = 16, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


ENCODER_TREE = dict(vocab_size=101, hidden=16, layers=1, heads=2, intermediate=32, max_len=16)
TOPK_ROWS = 16  # sharded_topk's direct case: fewer rows per rank than K_BIG at worlds 2 and 4
K_BIG = 10
CACHE_SIZES = (100, 300, 1500)  # below and above MIN_DEVICE_ROWS
INDEX_BLOCK = 8
INDEX_ROWS = (36, 3)  # two adds; the second stays within the first's capacity at worlds 1, 2 and 4
KNN_ROWS = 300


def encoder_tree() -> dict:
    from pathway_tpu_torch.models.encoder import EncoderConfig, init_params

    return init_params(EncoderConfig(**ENCODER_TREE), 0, head=True)


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def knn_requests(d: int):
    queries = index_data(6, d, seed=9)[0]
    return [
        (queries[0], 5, None),
        (queries[1], None, None),
        (queries[2], 4, "owner == 'kim'"),
        (queries[3], 3, "owner == 'lee' && size > 50"),
        (queries[4], 2, None),
    ]


def knn_meta(i: int) -> dict:
    return {"owner": "kim" if i % 3 == 0 else "lee", "size": int(i)}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_cases(rank: int, world: int) -> dict:
    from torch.distributed.tensor import Shard

    from pathway_tpu_torch.ops import topk
    from pathway_tpu_torch.parallel import (
        ShardedDeviceIndex,
        flat_axes,
        make_mesh,
        put_global,
        shard_batch,
        shard_params,
        sharded_topk,
    )
    from pathway_tpu_torch.parallel.mesh import flat_rank
    from pathway_tpu_torch.stdlib.indexing import nearest_neighbors as nn_

    out: dict = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = dict(
        names=tuple(mesh.mesh_dim_names), shape=tuple(mesh.shape), flat_axes=flat_axes(mesh),
        flat_rank=flat_rank(mesh), coordinate=tuple(mesh.get_coordinate()),
    )
    try:
        make_mesh(world * 2, device="cpu")
    except ValueError as e:
        out["mesh"]["more_than_world"] = str(e)

    tree = encoder_tree()
    placed = shard_params(tree, mesh)
    out["params"] = {
        "/".join(path): dict(
            placements=tuple(str(p) for p in dt.placements),
            local_shape=tuple(dt.to_local().shape),
            equal=bool(torch.equal(dt.full_tensor(), torch.from_numpy(leaf))),
        )
        for (path, leaf), (_, dt) in zip(_leaves(tree), _leaves(placed))
    }
    batch = {"ids": np.arange(8 * 3, dtype=np.int64).reshape(8, 3), "mask": np.ones((8, 3), np.int32)}
    sharded = shard_batch(batch, mesh)
    out["batch"] = {k: (tuple(str(p) for p in v.placements), v.to_local().numpy()) for k, v in sharded.items()}
    rows = np.arange(world * 3 * 2, dtype=np.float32).reshape(world * 3, 2)
    out["put_global_rows"] = put_global(rows, mesh, (Shard(0),) * mesh.ndim).to_local().numpy()

    docs, queries = index_data(TOPK_ROWS)
    mask = np.zeros(TOPK_ROWS, np.float32)
    mask[-3:] = -np.inf
    rows_shard = (Shard(0),) * mesh.ndim
    out["sharded_topk"] = {}
    for metric in METRICS:
        for k in (3, K_BIG):
            idx, vals = sharded_topk(
                mesh, put_global(docs, mesh, rows_shard), put_global(mask, mesh, rows_shard), queries, k, metric
            )
            out["sharded_topk"][metric, k] = (idx.numpy(), vals.numpy())

    out["index"] = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        first = unit_rows(INDEX_ROWS[0], seed=1)
        index = ShardedDeviceIndex(mesh, first.shape[1], block=INDEX_BLOCK, dtype=dtype)
        empty = index.search(first[:2], 3)
        index.add(first)
        probe = first[[0, 7, 23]] + 0.01
        res = [index.search(probe, 5)]
        cap = index._docs.shape[0]
        second = unit_rows(INDEX_ROWS[1], seed=2)
        index.add(second)
        res.append(index.search(np.concatenate([probe, second[:2]]), 5))
        out["index"][name] = dict(
            empty=tuple(a.shape for a in empty), results=res, capacities=(cap, index._docs.shape[0]),
            local_rows=index._docs.to_local().shape[0], dtype=str(index._docs.dtype), n=len(index),
        )

    out["cache"] = {}
    for n in CACHE_SIZES:
        for metric in METRICS:
            matrix, qs = index_data(n, q=7)
            cache = topk.DeviceIndexCache(mesh=mesh)
            got = topk.topk_search_cached(matrix, qs, 5, metric, cache=cache, version=1)
            single = topk.topk_search_cached(
                matrix, qs, 5, metric, cache=topk.DeviceIndexCache(device="cpu"), version=1
            )
            padded, cmask, _ = cache.get(matrix, 1, metric)
            out["cache"][n, metric] = dict(
                mesh=got, single=single, capacity=padded.shape[0], local=padded.to_local().shape[0],
                mask=cmask.to_local().numpy(),
            )
    # warm-capacity growth: more rows within the same capacity reuse its shape
    matrix, qs = index_data(300, q=4, seed=3)
    cache = topk.DeviceIndexCache(mesh=mesh)
    topk.topk_search_cached(matrix, qs, 3, "cos", cache=cache, version=1)
    cap = cache._padded.shape[0]
    grown = np.concatenate([matrix, qs], axis=0)
    idx, _ = topk.topk_search_cached(grown, qs, 2, "cos", cache=cache, version=2)
    out["cache_growth"] = dict(capacities=(cap, cache._padded.shape[0]), idx=idx, n=grown.shape[0])

    out["knn"] = {}
    for metric in METRICS:
        matrix, _ = index_data(KNN_ROWS, seed=5)
        requests = knn_requests(matrix.shape[1])
        got = []
        for index in (
            nn_.BruteForceKnnIndex(nn_.DistanceMetric(metric), mesh=mesh),
            nn_.BruteForceKnnIndex(nn_.DistanceMetric(metric), device="cpu"),
        ):
            for i, vec in enumerate(matrix):
                index.add(1000 + i, vec, knn_meta(i))
            got.append(index.search_many(requests))
        out["knn"][metric] = tuple(got)
    return out


def mesh_branch_case(rank: int, world: int, matrix: np.ndarray, queries: np.ndarray):
    from pathway_tpu_torch.ops import topk
    from pathway_tpu_torch.parallel import make_mesh

    cache = topk.DeviceIndexCache(device="cpu", mesh=make_mesh(device="cpu"))
    return topk.topk_search_cached(matrix, queries, 5, "cos", cache=cache, version=1)


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py
# ---------------------------------------------------------------------------

# tests/test_ring_attention.py:24-33's shapes and :62's, S halved for the
# CPU's time (chip_smoke.py runs them whole on the card)
RING_SHAPES = [(2, 128, 384, 12), (1, 256, 768, 12), (1, 512, 384, 12), (1, 1024, 384, 6)]
TRUTH_SHAPE = (1, 1024, 384, 12)
PIN_SHAPE = (1, 256, 384, 12)
INDIVISIBLE_S = 101


def ring_inputs(B: int, S: int, H: int, seed: int, masked_from: float):
    """f32 q, k, v from numpy and the key bias with a masked tail; the
    callers round q, k, v to bf16 (the same round-to-nearest-even in both
    packages)."""
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(B, S, H)).astype(np.float32) for _ in range(3))
    bias = np.zeros((B, S), np.float32)
    bias[:, int(S * masked_from):] = -1e9
    return q, k, v, bias


def ring_cases(rank: int, world: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from pathway_tpu_torch.parallel import make_mesh, ring_encoder_attention

    def bf16(x):
        return torch.from_numpy(x).to(torch.bfloat16)

    def block(t):
        return t.float().numpy()

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
    out: dict = {"shapes": {}}
    for shape in RING_SHAPES:
        B, S, H, heads = shape
        q, k, v, bias = ring_inputs(B, S, H, 0, 0.9)
        out["shapes"][shape] = block(
            ring_encoder_attention(mesh, bf16(q), bf16(k), bf16(v), torch.from_numpy(bias), heads)
        )
    B, S, H, heads = TRUTH_SHAPE
    q, k, v, bias = ring_inputs(B, S, H, 2, 0.95)
    out["truth"] = block(ring_encoder_attention(mesh, bf16(q), bf16(k), bf16(v), torch.from_numpy(bias), heads))
    out["f32"] = block(
        ring_encoder_attention(
            mesh, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bias), heads
        )
    )
    B, S, H, heads = PIN_SHAPE
    q, k, v, bias = ring_inputs(B, S, H, 1, 0.5)
    k2, v2 = k.copy(), v.copy()
    k2[:, S // 2:] = 77.0
    v2[:, S // 2:] = -77.0
    out["pin"] = [
        block(ring_encoder_attention(mesh, bf16(q), bf16(kk), bf16(vv), torch.from_numpy(bias), heads))
        for kk, vv in ((k, v), (k2, v2))
    ]
    zeros = torch.zeros((1, INDIVISIBLE_S, 384), dtype=torch.bfloat16)
    try:
        ring_encoder_attention(mesh, zeros, zeros, zeros, torch.zeros((1, INDIVISIBLE_S)), 12)
    except ValueError as e:
        out["indivisible"] = str(e)
    # a ring over the data axis of the 2-D mesh; the model ranks replicate
    mesh2 = make_mesh(device="cpu")
    B, S, H, heads = RING_SHAPES[0]
    q, k, v, bias = ring_inputs(B, S, H, 3, 0.9)
    out["data_ring"] = dict(
        coordinate=tuple(mesh2.get_coordinate()),
        block=block(ring_encoder_attention(mesh2, bf16(q), bf16(k), bf16(v), torch.from_numpy(bias), heads,
                                           axis="data")),
    )
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_long_context.py
# ---------------------------------------------------------------------------


def long_context_texts(seed: int = 0) -> list[str]:
    """Short, middling and long texts: the longest passes ``max_len`` (32)
    ids at worlds 2 and 4 and is cut to the ring's ``max_len × n``."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, size=int(m))) for m in rng.integers(3, 9, size=400)]
    return [
        " ".join(str(w) for w in rng.choice(words, size=int(n)))
        for n in (3, 9, 20, 28, 45, 70, 110)
    ] + ["short", ""]


LONG_BATCH_MATE = "x " * 900


def long_context_cases(rank: int, world: int, model_dirs: dict, params_path: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from pathway_tpu_torch.models.long_context import LongContextSentenceEncoder, shared_long_context_encoder
    from pathway_tpu_torch.ops import attention

    with open(params_path, "rb") as f:
        params = pickle.load(f)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("sp",))
    texts = long_context_texts()
    out: dict = {}
    attention.encoder_attention.launches = 0
    for pooling, model_dir in model_dirs.items():
        enc = LongContextSentenceEncoder(model_dir, mesh)
        enc.set_params(params)
        out[pooling] = dict(
            embeddings=enc.encode(texts),
            alone=enc.encode(["a modest sentence"])[0],
            padded=enc.encode(["a modest sentence", LONG_BATCH_MATE])[0],
            seq_buckets=[enc._bucket_seq(n) for n in (1, 17, 33, 200, 10_000)],
            ids=[len(enc.tokenizer.encode(t, max_length=enc.config.max_len * world)) for t in texts],
            uncut=[len(enc.tokenizer.encode(t, max_length=10**6)) for t in texts],
        )
    out["encoder_launches"] = attention.encoder_attention.launches
    out["shared_is_cached"] = shared_long_context_encoder(model_dirs["mean"], mesh) is shared_long_context_encoder(
        model_dirs["mean"], mesh
    )
    if world == 1:
        from pathway_tpu_torch.models.encoder import SentenceEncoder

        single = SentenceEncoder(model_dirs["mean"], device="cpu")
        single.set_params(params)
        out["single"] = single.encode(texts)
    return out
