"""Training-state checkpoint and resume, on one device or on a mesh.

Counterpart of ``pathway_tpu/parallel/checkpoint.py`` (orbax's
``CheckpointManager``): :class:`TrainCheckpointer` writes a
:class:`~pathway_tpu_torch.parallel.train.TrainState` (params, the
optimizer's ``state_dict`` and the step) into ``directory/<step>/``, keeps
the newest ``max_to_keep`` steps, and restores one onto the devices and
dtypes of a ``like`` state (typically a fresh ``init``).

* **Atomic saves.**  A step is written under a temporary name in the same
  directory, flushed to disk, then renamed to ``<step>``: a crash leaves
  either the whole step or none of it, and ``all_steps`` never sees a
  partial one.
* **Frozen leaves are the caller's.**  Leaves that do not require grad (a
  LoRA base) are not written, as a base checkpoint is not part of a
  fine-tune's state; their paths, shapes and dtypes are, and ``restore``
  checks them against ``like``'s and keeps ``like``'s values.  Every leaf
  of a full fine-tune, a contrastive or an MoE state is trainable and
  written.

* **Sharded saves.**  A state whose params are mesh-placed DTensors is
  written through ``torch.distributed.checkpoint``: each rank writes its
  own shards of the trainable leaves and of their optimizer moments into
  the step's directory, and rank 0 writes ``meta.pt`` (the step, the
  trainable leaves' names, the frozen leaves' shapes and dtypes, the
  optimizer's hyperparameters).  Every rank calls ``save`` and
  ``restore``.  A restore reads the shards onto ``like``'s placements,
  whatever mesh wrote them.  A single-device state keeps the one-file
  format (``state.pt``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from pathway_tpu_torch.parallel.train import TrainState, named_leaves

_FILE = "state.pt"
_META = "meta.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpointer:
    """Save/restore ``TrainState`` snapshots under ``directory/<step>/``."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState) -> int:
        """Write ``state`` at its step number; returns the step.  Raises
        ``FileExistsError`` if that step is already saved, as orbax does."""
        step = int(state.step)
        final = self._path(step)
        if os.path.exists(final):
            raise FileExistsError(f"step {step} is already saved under {self.directory!r}")
        leaves = named_leaves(state.params)
        if any(isinstance(t, DTensor) for t in leaves.values()):
            return self._save_sharded(state, leaves)
        payload = {
            "step": step,
            "params": {name: t.detach() for name, t in leaves.items() if t.requires_grad},
            "frozen": {name: (tuple(t.shape), str(t.dtype)) for name, t in leaves.items()
                       if not t.requires_grad},
            "opt_state": state.opt_state.state_dict(),
        }
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self.directory)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._path(old))
        return step

    def all_steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(self._path(int(name))))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: TrainState, step: int | None = None) -> TrainState:
        """Restore the checkpoint at ``step`` (default: newest) into
        ``like``: every saved leaf is copied into ``like``'s tensor of the
        same path (its device and dtype), the optimizer state is loaded
        into ``like``'s optimizer (which casts it to its params' devices
        and dtypes), and ``like``'s tensors are returned at that step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory!r}")
        leaves = named_leaves(like.params)
        if os.path.exists(os.path.join(self._path(step), _META)):
            return self._restore_sharded(like, leaves, step)
        if any(isinstance(t, DTensor) for t in leaves.values()):
            raise ValueError(f"checkpoint step {step} was written by one device; a mesh-placed like-state "
                             "restores sharded checkpoints only")
        saved = torch.load(os.path.join(self._path(step), _FILE), map_location="cpu", weights_only=True)
        _check_like(leaves, set(saved["params"]), saved["frozen"], step)
        with torch.no_grad():
            for name, value in saved["params"].items():
                if tuple(value.shape) != tuple(leaves[name].shape):
                    raise ValueError(f"leaf {name!r}: saved {list(value.shape)}, like {list(leaves[name].shape)}")
                leaves[name].copy_(value)
        like.opt_state.load_state_dict(saved["opt_state"])
        return TrainState(params=like.params, opt_state=like.opt_state, step=int(step))

    def _save_sharded(self, state: TrainState, leaves: dict) -> int:
        import torch.distributed.checkpoint as dcp

        step = int(state.step)
        final = self._path(step)
        exists = os.path.exists(final)
        dist.barrier()  # every rank has looked before any can publish the step
        if exists:
            raise FileExistsError(f"step {step} is already saved under {self.directory!r}")
        tmp = os.path.join(self.directory, f".{step}.sharded")
        if dist.get_rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)  # a crashed save's leftovers
        dist.barrier()
        trainable = {name: t for name, t in leaves.items() if t.requires_grad}
        dcp.save(_sharded_state(trainable, state.opt_state), checkpoint_id=tmp)
        if dist.get_rank() == 0:
            meta = {
                "step": step,
                "trainable": sorted(trainable),
                "frozen": {name: (tuple(t.shape), str(t.dtype)) for name, t in leaves.items() if not t.requires_grad},
                "param_groups": [{k: v for k, v in g.items() if k != "params"} for g in state.opt_state.param_groups],
            }
            with open(os.path.join(tmp, _META), "wb") as f:
                torch.save(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)
            _fsync_dir(self.directory)
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(self._path(old))
        dist.barrier()
        return step

    def _restore_sharded(self, like: TrainState, leaves: dict, step: int) -> TrainState:
        import torch.distributed.checkpoint as dcp

        meta = torch.load(os.path.join(self._path(step), _META), map_location="cpu", weights_only=True)
        _check_like(leaves, set(meta["trainable"]), meta["frozen"], step)
        trainable = {name: t for name, t in leaves.items() if t.requires_grad}
        _init_optimizer_state(like.opt_state)
        with torch.no_grad():
            dcp.load(_sharded_state(trainable, like.opt_state), checkpoint_id=self._path(step))
        for group, saved in zip(like.opt_state.param_groups, meta["param_groups"]):
            group.update(saved)
        return TrainState(params=like.params, opt_state=like.opt_state, step=int(step))

    def close(self) -> None:
        """Nothing to release: every save is complete when it returns."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _check_like(leaves: dict, trainable: set, frozen: dict, step: int) -> None:
    """Raise ``ValueError`` unless the like-state holds the saved trainable
    leaves and frozen leaves of the saved shapes and dtypes."""
    if set(leaves) != trainable | set(frozen):
        raise ValueError(
            f"checkpoint step {step} holds other leaves than the like-state: "
            f"{sorted(set(leaves) ^ (trainable | set(frozen)))[:8]}"
        )
    for name, (shape, dtype) in frozen.items():
        t = leaves[name]
        if t.requires_grad or tuple(t.shape) != tuple(shape) or str(t.dtype) != dtype:
            raise ValueError(
                f"frozen leaf {name!r} was saved as {dtype}{list(shape)}, not written; "
                f"the like-state has a {'trainable ' if t.requires_grad else ''}"
                f"{t.dtype}{list(t.shape)} there"
            )


def _sharded_state(trainable: dict, optimizer) -> dict:
    """The tensors a sharded step holds, by leaf name: the trainable leaves
    and each one's optimizer state (DTensor moments, a plain step count)."""
    return {
        "params": {name: t.detach() for name, t in trainable.items()},
        "optimizer": {name: dict(optimizer.state[t]) for name, t in trainable.items() if t in optimizer.state},
    }


def _init_optimizer_state(optimizer) -> None:
    """Give a fresh optimizer its per-leaf state, so that a sharded restore
    has tensors to read into: one step on zero gradients at learning rate
    0, which moves no param (``torch.distributed.checkpoint.state_dict``
    does the same)."""
    if optimizer.state:
        return
    params = [p for g in optimizer.param_groups for p in g["params"]]
    lrs = [g["lr"] for g in optimizer.param_groups]
    for p in params:
        p.grad = torch.zeros_like(p)
    for g in optimizer.param_groups:
        g["lr"] = 0.0
    optimizer.step()
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
