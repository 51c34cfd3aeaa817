"""Differentiable collectives for the tensor-, expert-, data- and
pipeline-parallel paths.

The JAX package writes its layouts as ``PartitionSpec``s and XLA inserts
the collectives and their transposes.  The port runs one process per card,
so each collective, and its gradient, is written here by hand as a
``torch.autograd.Function`` over a process group:

* :func:`copy_to` and :func:`reduce_from` are Megatron's pair.  A
  replicated activation enters a rank's share of a split layer through
  ``copy_to`` (identity forward, all-reduce of the partial gradients
  backward); the share's partial sums leave it through ``reduce_from``
  (all-reduce forward, identity backward).
* :func:`gather_from` joins a split last dim (the vocab-sharded logits):
  all-gather forward; backward keeps the rank's own slice, since every
  rank of the group computes the same loss from the joined tensor.
* :func:`gather_rows` joins the data-sharded rows: all-gather forward;
  backward sums the gradient over the group and keeps the rank's rows
  (a reduce-scatter), since each rank's loss is its share of the global
  loss.
* :func:`shift` is ``ppermute`` one step round the ring of the group;
  backward shifts the gradient back.  A group of one makes no hop.
* :func:`broadcast_from` gives every rank the ``src`` rank's tensor;
  backward hands the ``src`` rank its gradient and the others none, since
  every rank computes the same loss from the broadcast tensor.

Every function runs its collective at any group size, one included: a
world of one runs the same code as a world of many.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x, group, dim: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return own_rows(grad, ctx.group, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, grad):
        return own_rows(_all_reduce(grad, ctx.group), ctx.group), None


def _hop(x, group, step: int):
    """``x`` sent ``step`` ranks on round the group's ring, the tensor of
    the rank ``step`` behind received in its place (one
    ``batch_isend_irecv``)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:  # sending to one's own rank raises; a ring of one is the identity
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + step) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - step) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _hop(grad, ctx.group, -1), None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.own = dist.get_rank(group) == src
        x = x.contiguous().clone()
        dist.broadcast(x, dist.get_global_rank(group, src), group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.own else torch.zeros_like(grad)), None, None


def copy_to(x, group):
    """Identity forward; all-reduce of the gradient over ``group`` backward."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """All-reduce (sum) over ``group`` forward; identity backward."""
    return _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int = -1):
    """All-gather along ``dim`` forward; the rank's own slice backward."""
    return _GatherFrom.apply(x, group, dim % x.dim())


def gather_rows(x, group):
    """All-gather of dim 0 forward; reduce-scatter of the gradient backward."""
    return _GatherRows.apply(x, group)


def own_rows(x, group, dim: int = 0):
    """The rank's block of ``x`` along ``dim`` (the inverse of a gather).
    ``dim`` must split evenly over ``group``: a remainder would be no
    rank's rows, so it raises as ``put_global`` does."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


def shift(x, group):
    """``ppermute`` to the next rank of ``group``'s ring; backward shifts back."""
    return _Shift.apply(x, group)


def broadcast_from(x, group, src: int):
    """Rank ``src``'s ``x`` on every rank of ``group``; its gradient goes to
    ``src`` alone."""
    return _BroadcastFrom.apply(x, group, src)


def all_reduce_grads(params, group) -> None:
    """Sum the gradient of every leaf of ``params`` that has one over
    ``group``, in place: the data-parallel reduction of per-rank shares."""
    for p in params:
        if p.grad is not None:
            g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
            dist.all_reduce(g, group=group)
