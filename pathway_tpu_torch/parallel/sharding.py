"""Sharding rules for encoder parameters and batches, as DTensor placements.

Counterpart of ``pathway_tpu/parallel/sharding.py``.  Tensor parallelism:
2-D kernels split on their output (last) dimension over the ``model``
mesh dim when divisible; embeddings split on the vocab dimension;
everything else (biases, LayerNorm scales) is replicated.  A batch splits
its leading dimension over ``data``.  Each leaf becomes a ``DTensor``
through :func:`~pathway_tpu_torch.parallel.mesh.put_global`, so every
rank keeps only its own slice.

A layout given as a spec tree (the decoder's ``tp_param_specs``, the
MoE's ``ep_param_specs``, the pipeline's ``pp_param_specs``) holds, per
leaf, the JAX package's ``PartitionSpec`` as a tuple: the mesh axis each
tensor dim is split over, ``None`` where it is not, trailing dims
unnamed.  :func:`spec_placements` turns one into DTensor placements on a
mesh and :func:`place_tree` places a whole tree by one.
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


def spec_placements(spec: tuple, mesh: DeviceMesh) -> tuple:
    """DTensor placements of a tensor laid out by ``spec`` on ``mesh``:
    ``Shard(d)`` on the mesh dim that ``spec[d]`` names, replicated on the
    mesh dims it does not name (JAX's reading of a ``PartitionSpec``)."""
    dims = {axis: d for d, axis in enumerate(spec) if axis is not None}
    return tuple(Shard(dims[name]) if name in dims else Replicate() for name in mesh.mesh_dim_names)


def place_tree(tree, mesh: DeviceMesh, specs=None):
    """Every leaf of ``tree`` (nested dicts of tensors or arrays, the same
    full values on every rank) as a ``DTensor`` on ``mesh``, laid out by
    the spec of the same path in ``specs`` (every leaf replicated when
    ``specs`` is ``None``), in the leaf's own dtype.  A leaf where
    ``specs`` holds a tuple must be a tensor: a dict there (a LoRA weight
    ``{"w", "a", "b"}`` or an int8 pair ``{"q", "s"}``) raises
    ``ValueError``, as the JAX spec tree cannot map one either."""

    def place(node, spec, path):
        if hasattr(node, "items"):
            if isinstance(spec, tuple):
                raise ValueError(
                    f"leaf {'/'.join(path)!r} is a {sorted(node)} dict where the layout has one "
                    f"tensor spec {spec}: a LoRA or int8 weight has no layout; merge or "
                    "dequantize the tree first"
                )
            return {k: place(v, None if spec is None else spec[k], path + (k,)) for k, v in node.items()}
        return put_global(node, mesh, spec_placements(spec or (), mesh))

    return place(tree, specs, ())


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
