"""Long-context sentence encoding: a sequence-sharded trunk over a mesh.

Counterpart of ``pathway_tpu/models/long_context.py``, the consumer of
``parallel/ring_attention.py``: documents longer than one card's
comfortable sequence length are embedded by sharding the SEQUENCE axis of
the BERT trunk over one axis of the device mesh.  Each rank runs the
per-token work (QKV/FFN matmuls, layernorms, gelu) on its own block of
the sequence, attention runs as the K/V ring, and pooling reduces across
the blocks with one ``all_reduce`` of the masked sum and of the mask
count (mean) or takes block 0's first row (CLS), so every rank returns
the same embeddings.  As in the JAX package the trunk's attention is the
ring's plain f32 einsums: the encoder kernel is not on this path.

Beyond the checkpoint's position table, positions tile (chunk-local
positions, the standard long-document extension for absolute-position
BERT checkpoints; exact for ``S <= max_len``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from pathway_tpu_torch.models.encoder import (
    EncoderConfig,
    _ln,
    _to_numpy,
    config_for,
    init_model_params,
    pack_fast_params,
)
from pathway_tpu_torch.models.tokenizer import load_tokenizer, pad_batch
from pathway_tpu_torch.parallel.mesh import mesh_device
from pathway_tpu_torch.parallel.ring_attention import ring_attention_block


def _ring(mesh: DeviceMesh, axis: str | None):
    """(ring size, this rank's block index, the ring's group) of ``axis``
    (default: the mesh's first)."""
    axis = axis or mesh.mesh_dim_names[0]
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis), mesh.get_group(axis)


def long_context_trunk(tree, input_ids, attention_mask, config: EncoderConfig, mesh: DeviceMesh, axis=None):
    """BERT trunk with the sequence axis sharded over ``mesh``'s ``axis``.

    ``input_ids`` and ``attention_mask`` are the full ``[B, S]`` on every
    rank, ``S`` divisible by the axis size; returns this rank's block of
    the token reps, ``[B, S / n, H]``."""
    n, r, group = _ring(mesh, axis)
    B, S = input_ids.shape
    if S % n:
        raise ValueError(f"sequence length {S} not divisible by mesh axis {n}")
    blk = S // n
    rows = slice(r * blk, (r + 1) * blk)
    ids = input_ids[:, rows].long()
    mask = attention_mask[:, rows]
    H = config.hidden
    n_pos = tree["emb_pos"].shape[0]
    pos_ids = torch.arange(r * blk, (r + 1) * blk, device=ids.device) % n_pos
    x = tree["emb_word"][ids] + tree["emb_pos"][pos_ids][None, :, :]
    x = _ln(x, tree["eln_s"], tree["eln_b"])
    bias = torch.where(mask > 0, 0.0, -1e9).to(torch.float32)
    for lp in tree["layers"]:
        qkv = x @ lp["qkv_k"] + lp["qkv_b"]  # [B, S_blk, 3H]
        ctx = ring_attention_block(
            qkv[..., :H], qkv[..., H : 2 * H], qkv[..., 2 * H :], bias, config.heads, group
        )
        x = _ln(x + ctx @ lp["out_k"] + lp["out_b"], lp["ln0_s"], lp["ln0_b"])
        h = nn.functional.gelu(x @ lp["ff1_k"] + lp["ff1_b"], approximate="tanh")
        x = _ln(x + h @ lp["ff2_k"] + lp["ff2_b"], lp["ln1_s"], lp["ln1_b"])
    return x


def long_context_sentence_apply(tree, input_ids, attention_mask, config: EncoderConfig, mesh: DeviceMesh, axis=None):
    """Sequence-sharded equivalent of ``fused_sentence_apply``: the trunk,
    pooling over the whole sequence, L2 normalisation; the same f32
    ``[B, H]`` on every rank."""
    _, r, group = _ring(mesh, axis)
    x = long_context_trunk(tree, input_ids, attention_mask, config, mesh, axis)
    if config.pooling == "cls":
        pooled = x[:, 0, :].float().contiguous()  # block 0's first row, sent to the ring
        dist.broadcast(pooled, dist.get_global_rank(group, 0), group=group)
    else:
        blk = x.shape[1]
        m = attention_mask[:, r * blk : (r + 1) * blk, None].float()
        summed = (x.float() * m).sum(1)
        count = m.sum(1)
        dist.all_reduce(summed, group=group)
        dist.all_reduce(count, group=group)
        pooled = summed / torch.clamp(count, min=1.0)
    return pooled / (torch.linalg.norm(pooled, dim=1, keepdim=True) + 1e-12)


class LongContextSentenceEncoder:
    """Text → embeddings with the sequence axis sharded over a mesh.

    Same checkpoint and tokenizer handling as ``SentenceEncoder``; the
    forward shards S over ``mesh``'s ``axis`` (default: its first), so the
    longest text scales with the number of ranks instead of one card's
    memory.  It runs on the mesh's device; every rank encodes the same
    texts and returns the same vectors."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2", mesh: DeviceMesh | None = None, *, axis=None,
                 seed: int = 0, max_batch: int = 64):
        if mesh is None:
            raise ValueError("LongContextSentenceEncoder requires a DeviceMesh")
        self.mesh = mesh
        self.axis = axis or mesh.mesh_dim_names[0]
        self.device = mesh_device(mesh)
        self.config = config_for(model_name)
        self.model_name = model_name
        self.max_batch = max_batch
        self.tokenizer = load_tokenizer(model_name, self.config.vocab_size, self.config.max_len)
        params, self.pretrained = init_model_params(model_name, self.config, seed)
        self.set_params(params)

    def set_params(self, params) -> None:
        """Replace the weights with a Flax-structured tree, such as the JAX
        package's ``params`` after ``jax.device_get``."""
        self._tree = pack_fast_params(_to_numpy(params), self.config, self.device)

    @property
    def dimensions(self) -> int:
        return self.config.hidden

    def _bucket_seq(self, longest: int) -> int:
        """Sequence bucket: doubling AND divisible by the ring size (the ring
        needs equal blocks per rank) — the base is the smallest multiple of
        the ring size >= 16, so every doubling stays divisible."""
        n = _ring(self.mesh, self.axis)[0]
        seq = n * max(1, -(-16 // n))
        while seq < longest and seq < self.config.max_len * n:
            seq *= 2
        return seq

    def encode(self, texts: list[str]) -> np.ndarray:
        max_length = self.config.max_len * _ring(self.mesh, self.axis)[0]
        id_lists = [self.tokenizer.encode(t or "", max_length=max_length) for t in texts]
        seq = self._bucket_seq(max((len(x) for x in id_lists), default=1))
        out = []
        with torch.no_grad():
            for i in range(0, len(id_lists), self.max_batch):
                ids, mask = pad_batch(id_lists[i : i + self.max_batch], seq)
                res = long_context_sentence_apply(
                    self._tree,
                    torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(mask).to(self.device),
                    self.config,
                    self.mesh,
                    self.axis,
                )
                out.append(res.cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.dimensions), np.float32)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]


_SHARED: dict = {}


def shared_long_context_encoder(model_name: str, mesh: DeviceMesh, axis=None) -> LongContextSentenceEncoder:
    """Per-(model, mesh, axis) cache, mirroring ``shared_sentence_encoder``:
    repeated embedder construction must not reload weights."""
    key = (model_name, id(mesh), axis)
    enc = _SHARED.get(key)
    if enc is None:
        enc = _SHARED[key] = LongContextSentenceEncoder(model_name, mesh, axis=axis)
    return enc
