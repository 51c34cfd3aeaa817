"""Bidirectional (encoder) multi-head attention: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``pathway_tpu/ops/attention.py::encoder_attention`` (the
Pallas kernel ``_attn_kernel``) and of its plain XLA path
``_xla_attention``.  q, k and v stay in the packed ``[B, S, H]`` layout the
fused QKV projection produces (heads in the last dim); in the trunk they are
column slices of one ``[B*S, 3H]`` tensor, and the kernel reads them there,
row stride and all, so no relayout copy is made.  The kernel's source and
design notes are in ``csrc/encoder_attention.cu``.

On a CPU tensor :func:`encoder_attention` runs the plain version; on a CUDA
tensor it launches the kernel or raises — it never falls back.  The paged
decoder ops of the JAX module wait for the decoder slice of the port.
"""

from __future__ import annotations

import ctypes

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


def _kernel():
    lib = _build.load("encoder_attention")
    fn = lib.encoder_attention_bf16
    if not fn.argtypes:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [ptr] * 5 + [ctypes.c_int] * 4 + [i64] * 6 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def _row_strides(t: torch.Tensor, name: str, B: int, S: int, H: int) -> tuple[int, int]:
    """(batch stride, row stride) of a ``[B, S, H]`` operand the kernel can
    read in place: unit column stride and 4-byte aligned bf16 pairs."""
    if tuple(t.shape) != (B, S, H):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, S, H)}")
    sb, ss, sc = t.stride()
    if sc != 1 or sb % 2 or ss % 2 or t.data_ptr() % 4:
        raise ValueError(
            f"{name} needs a unit column stride and even row strides on a "
            f"4-byte aligned base (got strides {t.stride()})"
        )
    return sb, ss


def encoder_attention(q, k, v, mask_bias, heads: int):
    """Bidirectional multi-head attention over packed-layout tensors.

    Args:
      q, k, v: ``[B, S, H]`` (heads packed in the last dim, ``H = heads*hd``);
        on CUDA bf16 with a unit column stride (any row stride).
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
    rc = _kernel()(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        bias.data_ptr(),
        out.data_ptr(),
        B,
        S,
        heads,
        hd,
        *strides,
        1.0 / (hd**0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"encoder_attention kernel launch failed: CUDA error {rc}")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
