"""Bidirectional (encoder) multi-head attention: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``pathway_tpu/ops/attention.py::encoder_attention`` (the
Pallas kernel ``_attn_kernel``) and of its plain XLA path
``_xla_attention``.  q, k and v stay in the packed ``[B, S, H]`` layout the
fused QKV projection produces (heads in the last dim); in the trunk they are
column slices of one ``[B*S, 3H]`` tensor, and the kernel reads them there,
row stride and all, so no relayout copy is made.  :func:`plan` cuts a call
into the kernel's work items (head groups of 128 columns by up to 64 rows,
short sequences packed); the kernel's source and design notes are in
``csrc/encoder_attention.cu``.

On a CPU tensor :func:`encoder_attention` runs the plain version; on a CUDA
tensor it launches the kernel or raises — it never falls back.

The decoder's grouped-query attention (:func:`gqa_attention`) and the paged
KV ops (:func:`gather_kv_pages`, :func:`paged_gqa_attention`,
:func:`scatter_kv_pages`) are the JAX module's XLA compositions, which have
no Pallas kernel there; they run as plain PyTorch ops on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from pathway_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (32, 64, 128)


def _supported(S: int, H: int, heads: int) -> bool:
    """Whether the CUDA kernel takes this shape (any S; hd of 32, 64 or 128)."""
    if H % heads:
        return False
    return S >= 1 and H // heads in KERNEL_HEAD_DIMS


def encoder_attention_reference(q, k, v, mask_bias, heads: int):
    """Plain batched attention, the counterpart of ``_xla_attention``:
    bf16 products summed in f32, softmax in f32, probabilities rounded to
    the input dtype before the PV product."""
    B, S, H = q.shape
    hd = H // heads
    scale = 1.0 / (hd**0.5)
    q4 = q.reshape(B, S, heads, hd).transpose(1, 2)  # [B, heads, S, hd]
    k4 = k.reshape(B, S, heads, hd).transpose(1, 2)
    v4 = v.reshape(B, S, heads, hd).transpose(1, 2)
    scores = torch.matmul(q4.float(), k4.float().transpose(-1, -2))
    scores = scores * scale + mask_bias[:, None, None, :].float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs, v4)  # [B, heads, S, hd]
    return ctx.transpose(1, 2).reshape(B, S, H)


GROUP_COLS = 128  # columns per work item: one head group, the TPU kernel's LANE_GROUP
TILE_ROWS = 64  # query rows per work item, and keys per chunk
MMA_ROWS = 16  # height of one tensor-core tile


class Plan(NamedTuple):
    """How the kernel cuts one call into work items.

    Item ``it`` covers head group ``g = it % groups`` (columns ``[128*g,
    min(128*(g+1), H))``), query tile ``c = (it // groups) % chunks`` (rows
    ``[seq_rows*c, seq_rows*(c+1))`` of each sequence) and the ``seqs``
    sequences from ``(it // groups // chunks) * seqs`` on.  For S <= 64 a
    sequence takes ``seq_rows`` = S rounded up to 16 rows and an item packs
    ``64 // seq_rows`` of them; for S > 64 an item is 64 query rows of one
    sequence, and ``chunks`` is also the number of 64-key chunks it walks.
    The kernel takes these numbers as they are and decodes ``it`` the same
    way (``Plan`` in ``csrc/encoder_attention.cu``).
    """

    seq_rows: int
    seqs: int
    chunks: int
    groups: int
    items: int


def plan(B: int, S: int, H: int) -> Plan:
    """The work items of one call on ``[B, S, H]`` operands."""
    if S <= TILE_ROWS:
        seq_rows = -(-S // MMA_ROWS) * MMA_ROWS
        seqs = TILE_ROWS // seq_rows
    else:
        seq_rows, seqs = TILE_ROWS, 1
    chunks = -(-S // seq_rows)
    groups = -(-H // GROUP_COLS)
    return Plan(seq_rows, seqs, chunks, groups, -(-B // seqs) * chunks * groups)


def _kernel():
    lib = _build.load("encoder_attention")
    fn = lib.encoder_attention_bf16
    if not fn.argtypes:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [i64] * 6 + [i32] * 6 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    """SMs of card ``index``: the persistent grid has one CTA on each."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _row_strides(t: torch.Tensor, name: str, B: int, S: int, H: int) -> tuple[int, int]:
    """(batch stride, row stride) of a ``[B, S, H]`` bf16 operand the kernel
    can read in place through a TMA tensor map: unit column stride, a
    16-byte aligned base, and row and batch strides of whole 16 bytes (8
    elements)."""
    if tuple(t.shape) != (B, S, H):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, S, H)}")
    sb, ss, sc = t.stride()
    if sc != 1 or sb % 8 or ss % 8 or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a unit column stride and row and batch strides of a "
            f"multiple of 8 elements on a 16-byte aligned base (got strides "
            f"{t.stride()}, base {t.data_ptr()} mod 16 = {t.data_ptr() % 16})"
        )
    return sb, ss


def encoder_attention(q, k, v, mask_bias, heads: int):
    """Bidirectional multi-head attention over packed-layout tensors.

    Args:
      q, k, v: ``[B, S, H]`` (heads packed in the last dim, ``H = heads*hd``);
        on CUDA bf16 with a unit column stride, row and batch strides of a
        multiple of 8 elements and a 16-byte aligned base (as column views
        of the fused ``[B*S, 3H]`` QKV output are).
      mask_bias: ``[B, S]`` additive key bias (0 for valid, ``-1e9`` for pad).
      heads: number of attention heads.
    Returns:
      ctx ``[B, S, H]``, contiguous, in the dtype of ``q``.
    """
    if q.device.type == "cpu":
        return encoder_attention_reference(q, k, v, mask_bias, heads)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention runs on cuda or cpu, not {q.device}")
    B, S, H = q.shape
    if not _supported(S, H, heads):
        raise ValueError(
            f"the CUDA encoder-attention kernel takes head dims "
            f"{KERNEL_HEAD_DIMS}; got H={H}, heads={heads}"
        )
    for name, t in (("q", q), ("k", k), ("v", v), ("mask_bias", mask_bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    strides = [s for name, t in (("q", q), ("k", k), ("v", v)) for s in _row_strides(t, name, B, S, H)]
    if tuple(mask_bias.shape) != (B, S):
        raise ValueError(f"mask_bias has shape {tuple(mask_bias.shape)}, expected {(B, S)}")
    bias = mask_bias.to(torch.float32).contiguous()
    out = torch.empty((B, S, H), dtype=torch.bfloat16, device=q.device)
    hd = H // heads
    p = plan(B, S, H)
    rc = _kernel()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        bias.data_ptr(),
        out.data_ptr(),
        B,
        S,
        H,
        hd,
        *strides,
        *p,
        min(p.items, _sm_count(q.get_device())),
        1.0 / (hd**0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc < 0:
        raise RuntimeError(f"encoder_attention: cannot encode a TMA tensor map: CUresult {-rc}")
    if rc:
        raise RuntimeError(f"encoder_attention kernel launch failed: CUDA error {rc}")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0


# ---------------------------------------------------------------------------
# Decoder attention: dense GQA and the paged KV cache
# ---------------------------------------------------------------------------
#
# The continuous-batching decode loop (serving/generation.py) keeps each
# request's KV in fixed-size PAGES of a preallocated pool; a per-slot block
# table maps logical positions onto pool pages.  Page 0 is the null page:
# unallocated table entries point at it and padding writes land in it.


def gqa_attention(q, k, v, mask):
    """Grouped-query attention: q ``[B, S, NH, D]``, k/v ``[B, C, KH, D]``,
    mask ``[B, S, C]`` boolean (True = attend).  Scores in f32 (the
    products of the inputs summed in f32), masked with -1e9, softmax in
    f32, probabilities rounded to the input dtype before the PV product.
    Returns ``[B, S, NH*D]``."""
    B, S, NH, D = q.shape
    C, KH = k.shape[1], k.shape[2]
    G = NH // KH
    qg = q.float().reshape(B, S, KH, G, D).permute(0, 2, 3, 1, 4).reshape(B, KH, G * S, D)
    scores = torch.matmul(qg, k.float().permute(0, 2, 3, 1)).reshape(B, KH, G, S, C)
    scores = scores / math.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs.reshape(B, KH, G * S, C), v.permute(0, 2, 1, 3))
    return ctx.reshape(B, KH, G, S, D).permute(0, 3, 1, 2, 4).reshape(B, S, NH * D)


def gather_kv_pages(pool, block_tables):
    """Each slot's logical cache ``[S, G*page, KH, D]`` out of one layer's
    page pool ``[P, page, KH, D]`` through ``block_tables [S, G]``.
    Positions gathered through null entries are masked by the caller."""
    S, G = block_tables.shape
    return pool[block_tables].reshape(S, G * pool.shape[1], pool.shape[2], pool.shape[3])


def paged_gqa_attention(q, k_pool, v_pool, block_tables, mask):
    """GQA attention against paged KV: q ``[S, T, NH, D]``, pools
    ``[P, page, KH, D]``, block_tables ``[S, G]``, mask ``[S, T, G*page]``.
    The dense path's math (:func:`gqa_attention`) over the gathered
    context, so paged and dense generations agree."""
    k = gather_kv_pages(k_pool, block_tables)
    v = gather_kv_pages(v_pool, block_tables)
    return gqa_attention(q, k, v, mask)


def kv_rows(block_tables, positions, page: int):
    """Rows of the flattened ``[P*page, KH, D]`` pool that logical
    ``positions [S, T]`` map to through each slot's block table.  A
    position past the table's width maps into the null page, never into
    the slot's last live page."""
    G = block_tables.shape[1]
    slot_of = positions // page
    page_idx = torch.gather(block_tables, 1, slot_of.clamp(0, G - 1))
    page_idx = torch.where(slot_of >= G, 0, page_idx)
    return page_idx * page + positions % page


def write_kv_rows(pool, rows, values):
    """Write ``values [S, T, KH, D]`` at the pool rows of :func:`kv_rows`,
    in place.  Rows that repeat are null-page padding; which write wins
    there does not matter."""
    flat = pool.view(-1, pool.shape[2], pool.shape[3])
    flat[rows.reshape(-1)] = values.reshape(-1, values.shape[2], values.shape[3])
    return pool


def scatter_kv_pages(pool, block_tables, positions, values):
    """Write per-slot K or V rows ``values [S, T, KH, D]`` at logical
    ``positions [S, T]`` into the page pool ``[P, page, KH, D]`` (in
    place; also returned).  Positions whose table entry is 0, or which
    lie past the table, land in the null page."""
    return write_kv_rows(pool, kv_rows(block_tables, positions, pool.shape[1]), values)
