"""Sharding rules for encoder parameters and batches, as DTensor placements.

Counterpart of ``pathway_tpu/parallel/sharding.py``.  Tensor parallelism:
2-D kernels split on their output (last) dimension over the ``model``
mesh dim when divisible; embeddings split on the vocab dimension;
everything else (biases, LayerNorm scales) is replicated.  A batch splits
its leading dimension over ``data``.  Each leaf becomes a ``DTensor``
through :func:`~pathway_tpu_torch.parallel.mesh.put_global`, so every
rank keeps only its own slice.  Their consumer, the data- and
tensor-parallel train step, comes with the next multi-GPU slice.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from pathway_tpu_torch.parallel.mesh import put_global


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements that replicate a tensor on every rank."""
    return (Replicate(),) * mesh.ndim


def _spec_for(path: tuple, leaf, model_size: int) -> int | None:
    """The leaf's dim split over ``model`` (``None``: replicated), by the
    JAX package's ``_spec_for`` rule."""
    if leaf.ndim >= 2:
        # embedding tables: shard the (large) vocab/row dimension
        name = "/".join(str(p) for p in path).lower()
        if "embed" in name and leaf.shape[0] % model_size == 0:
            return 0
        # dense kernels: shard the output features
        if leaf.shape[-1] % model_size == 0 and leaf.shape[-1] >= model_size:
            return leaf.ndim - 1
    return None


def _placements(mesh: DeviceMesh, axis: str, dim: int | None) -> tuple:
    """``Shard(dim)`` on the mesh dim named ``axis``, replicated elsewhere."""
    return tuple(
        Shard(dim) if name == axis and dim is not None else Replicate()
        for name in mesh.mesh_dim_names
    )


def _map_with_path(fn, tree, path=()):
    if hasattr(tree, "items"):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params(params, mesh: DeviceMesh):
    """Place a parameter tree (nested dicts of arrays) on the mesh with
    tensor-parallel sharding."""
    names = mesh.mesh_dim_names
    model_size = mesh.size(names.index("model")) if "model" in names else 1

    def place(path, leaf):
        return put_global(leaf, mesh, _placements(mesh, "model", _spec_for(path, leaf, model_size)))

    return _map_with_path(place, params)


def shard_batch(batch, mesh: DeviceMesh):
    """Shard the leading (batch) dimension of every leaf over ``data``."""
    placements = _placements(mesh, "data", 0)
    return _map_with_path(lambda _path, leaf: put_global(leaf, mesh, placements), batch)
