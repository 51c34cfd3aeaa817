"""Device mesh construction on ``torch.distributed``.

Counterpart of ``pathway_tpu/parallel/mesh.py``.  The reference sizes its
worker grid from ``PATHWAY_THREADS`` × ``PATHWAY_PROCESSES``
(``src/engine/dataflow/config.rs:88-120``); here the grid is a
``torch.distributed`` ``DeviceMesh`` over ``("data", "model")``, one rank
(one process) per card, with NCCL between cards and gloo between CPU
ranks.  JAX has one controller owning every device of the host; PyTorch
runs one process per card, so a mesh covers the process group's world:
it cannot hold several devices in one process, and asking for more
devices than ranks raises.

``put_global`` keeps JAX's SPMD invariant: every rank holds the full host
array and keeps only its own slice, moved to its device and wrapped as a
``DTensor`` with the global shape.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.engine.faults import restart_attempt
from pathway_tpu_torch.internals.config import env_str, worker_topology

AXES = ("data", "model")


def _backend(device) -> str:
    """NCCL where the rank computes on a card, gloo on the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def resolve_coordinator(address: str | None = None) -> str:
    """The rendezvous of a multi-process group, as an ``init_method`` URL:
    ``address`` → ``PATHWAY_DEVICE_COORDINATOR`` → the first peer host (or
    localhost) at ``first_port + 1000 + restart_attempt()``, off the TCP
    mesh's ports and fresh for each supervised restart (the previous
    attempt's port may linger in teardown).  A bare ``host:port`` becomes
    ``tcp://host:port``; a URL (``file://...``) is taken as it is."""
    if address is None:
        address = env_str("PATHWAY_DEVICE_COORDINATOR")
    if address is None:
        topo = worker_topology()
        host = topo.peer_hosts[0] if topo.peer_hosts else "127.0.0.1"
        address = f"{host}:{topo.first_port + 1000 + restart_attempt()}"
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout: timedelta | None = None,
) -> bool:
    """Join the multi-process device group so a mesh spans every worker.

    The same resolution as the JAX package's, field by field: the argument,
    then the worker-cluster env (``PATHWAY_PROCESSES``,
    ``PATHWAY_PROCESS_ID``; the address as :func:`resolve_coordinator`).
    The group is NCCL when ``device`` (default: a card if there is one) is
    a card, gloo on the CPU.  Returns False (a no-op) at one process and
    True once a group exists.  A failed init reaches the caller raw."""
    if dist.is_initialized():
        return True
    topo = worker_topology()
    nproc = topo.processes if num_processes is None else num_processes
    pid = topo.process_id if process_id is None else process_id
    if nproc <= 1:
        return False
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend,
        init_method=resolve_coordinator(coordinator_address),
        world_size=nproc,
        rank=pid,
        **kwargs,
    )
    return True


def mesh_shape_for(n_devices: int, max_model: int = 2) -> tuple[int, int]:
    """Factor ``n_devices`` into (data, model).

    Tensor parallelism is capped at ``max_model`` — MiniLM/BGE-class
    encoders saturate a chip long before weight memory is a constraint, so
    extra chips are worth more as data parallelism.
    """
    model = 1
    for cand in range(min(max_model, n_devices), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    return n_devices // model, model


def make_mesh(n_devices: int | None = None, *, device=None, max_model: int = 2) -> DeviceMesh:
    """An ``("data", "model")`` mesh over the process group's world, one
    rank per device.  ``device`` picks the device type (default: a card;
    ``"cpu"`` for a gloo mesh).  Without a group, a multi-process worker
    env joins one (:func:`initialize_distributed`), and a single process
    makes a one-rank group in memory.  ``n_devices`` other than the
    world's size raises."""
    dev = resolve_device(device)
    if not initialize_distributed(device=dev):
        backend = _backend(dev)
        if backend == "nccl" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh covers the process group's world of {world} rank(s), one "
            f"device each; {n_devices} device(s) were asked for"
        )
    return init_device_mesh(dev.type, mesh_shape_for(world, max_model), mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def flat_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """All mesh axes — for state sharded over every chip (the index)."""
    return tuple(mesh.mesh_dim_names)


def flat_rank(mesh: DeviceMesh) -> int:
    """This rank's position in the flattened mesh, major axis first (the
    JAX package's ``_flat_axis_index``)."""
    idx = 0
    for dim, coord in enumerate(mesh.get_coordinate()):
        idx = idx * mesh.size(dim) + coord
    return idx


def put_global(arr, mesh: DeviceMesh, placements, *, dtype: torch.dtype | None = None) -> DTensor:
    """``arr`` (numpy or a tensor, the same full array on every rank) as a
    ``DTensor``: this rank keeps its own slice, cast to ``dtype`` and moved
    to its device, and nothing crosses ranks.  ``Shard(d)`` on several
    mesh dims splits ``d`` major dim first, as a JAX spec naming several
    axes does.  A sharded dim must divide evenly."""
    full = torch.as_tensor(arr)
    local = full
    for dim, (placement, coord) in enumerate(zip(placements, mesh.get_coordinate())):
        if placement.is_shard():
            n = mesh.size(dim)
            axis = placement.dim
            if local.shape[axis] % n:
                raise ValueError(f"dim {axis} of size {local.shape[axis]} does not split over {n} ranks")
            size = local.shape[axis] // n
            local = local.narrow(axis, coord * size, size)
    # a copy, never a view of the caller's array
    local = torch.empty(local.shape, dtype=dtype or full.dtype, device=mesh_device(mesh)).copy_(local)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=full.shape,
        stride=torch.empty(full.shape, device="meta").stride(),
    )


# Process-wide default mesh for device-resident indexes (the JAX package's
# analog of the reference attaching its external index to every SPMD
# worker).  Its reader, the index factories' late-bound default, comes with
# the host-engine slice of the port.
_DEFAULT_INDEX_MESH: DeviceMesh | None = None


def set_default_index_mesh(mesh: DeviceMesh | None) -> None:
    """Route all subsequently-built device indexes over ``mesh``."""
    global _DEFAULT_INDEX_MESH
    _DEFAULT_INDEX_MESH = mesh


def get_default_index_mesh() -> DeviceMesh | None:
    return _DEFAULT_INDEX_MESH
