"""Ring attention: sequence/context parallelism for long sequences.

Counterpart of ``pathway_tpu/parallel/ring_attention.py``.  The sequence
axis of bidirectional (encoder) attention is sharded over one axis of the
device mesh: every rank holds one sequence block of Q/K/V, and the K/V
blocks (with their key-bias block) rotate around the ring while each rank
accumulates its queries' attention with the online-softmax (flash)
recurrence: running row-max ``m``, denominator ``l`` and weighted sum
``o`` are updated per incoming block, so the full ``[S, S]`` score matrix
never materialises and sequences scale with the number of ranks.

Each rotation is one ``torch.distributed.batch_isend_irecv`` (send to the
next rank of the ring, receive from the previous), posted before the
local block's accumulate and waited after it, so the transfer overlaps
the compute, as XLA overlaps the JAX package's ``ppermute``.  Like the
JAX body, the arithmetic is plain f32 einsums: no Pallas kernel in the
JAX package, no hand kernel here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NEG_INF = -1e30


def _rotate(blocks, group):
    """Post one ring step: each block goes to the ring's next rank and its
    replacement comes from the previous one.  Returns the receive buffers
    and the requests to wait on."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prev = dist.get_global_rank(group, (r - 1) % n)
    received = [torch.empty_like(b) for b in blocks]
    ops = [dist.P2POp(dist.isend, b, nxt, group) for b in blocks]
    ops += [dist.P2POp(dist.irecv, b, prev, group) for b in received]
    return received, dist.batch_isend_irecv(ops)


def ring_attention_block(q, k, v, bias, heads: int, group) -> torch.Tensor:
    """The per-rank body (the JAX package's ``_ring_attention_local``):
    ``q``/``k``/``v`` ``[B, S_blk, H]`` with heads packed in the last dim and
    ``bias`` ``[B, S_blk]`` are the caller's own sequence block; the ring is
    ``group``'s ranks in order.  Returns the block's context in q's dtype."""
    B, S_blk, H = q.shape
    hd = H // heads
    scale = 1.0 / (hd**0.5)
    n = dist.get_world_size(group)

    def split(x):  # [B, heads, S_blk, hd]: a local reshape, S never gathers
        return x.reshape(B, S_blk, heads, hd).transpose(1, 2)

    q4 = split(q.float()) * scale

    def accumulate(k_blk, v_blk, b_blk, m, l, o):
        s = torch.einsum("bhqd,bhkd->bhqk", q4, split(k_blk.float())) + b_blk[:, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, split(v_blk.float()))
        return m_new, l, o

    m = torch.full((B, heads, S_blk), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, heads, S_blk), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, heads, S_blk, hd), dtype=torch.float32, device=q.device)
    blocks = [k.contiguous(), v.contiguous(), bias.float().contiguous()]
    # n-1 rotate-and-accumulate rounds; the final block accumulates without
    # the trailing rotation whose result would be discarded
    for _ in range(n - 1):
        received, reqs = _rotate(blocks, group)
        m, l, o = accumulate(*blocks, m, l, o)
        for req in reqs:
            req.wait()
        blocks = received
    m, l, o = accumulate(*blocks, m, l, o)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).reshape(B, S_blk, H).to(q.dtype)


def ring_attention_traced(mesh: DeviceMesh, q, k, v, mask_bias, heads: int, axis: str | None = None):
    """The JAX package's jit-traceable form of :func:`ring_encoder_attention`
    (no eager placement, so it composes inside a larger jitted forward).
    An eager PyTorch forward has no trace to compose into, so it is the
    same computation."""
    return ring_encoder_attention(mesh, q, k, v, mask_bias, heads, axis)


def ring_encoder_attention(mesh: DeviceMesh, q, k, v, mask_bias, heads: int, axis: str | None = None):
    """Bidirectional multi-head attention with the sequence axis sharded.

    Args:
      mesh: device mesh; ``axis`` names the ring's mesh dim (default: the
        first).  On a mesh of several dims each ring runs inside its group
        of ``axis`` and the other dims replicate.
      q, k, v: the full ``[B, S, H]`` on every rank (the SPMD invariant of
        ``put_global``), heads packed in the last dim; ``S`` must divide
        evenly by the axis size.
      mask_bias: ``[B, S]`` additive key bias (0 valid, ``-1e9`` padded).
    Returns:
      this rank's sequence block of the context, ``[B, S / n, H]``: the
      output sharded along ``S`` as the inputs are.
    """
    axis = axis or mesh.mesh_dim_names[0]
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    S = q.shape[1]
    if S % n:  # before any collective: the caller sees the actionable error
        raise ValueError(f"sequence length {S} not divisible by mesh axis {n}")
    blk = S // n
    r = mesh.get_local_rank(axis)
    rows = slice(r * blk, (r + 1) * blk)
    return ring_attention_block(
        q[:, rows], k[:, rows], v[:, rows], mask_bias[:, rows], heads, mesh.get_group(axis)
    )
