"""SigLIP-class multimodal dual encoder for the PyTorch port: a ViT image
tower and a text tower embedding into one shared space.

Counterpart of ``pathway_tpu/models/vision.py``.  The image tower is a
pre-LN ViT over a stacked ``[layers, ...]`` param tree: patchify (one
``[N, p*p*3] @ [p*p*3, H]`` projection), LayerNorm with f32 statistics and
eps 1e-6, attention with f32 scores and an f32 softmax, tanh GELU, a final
LayerNorm, a mean over patches, the projection and L2 normalisation.  The
JAX package's attention here is a plain einsum with no mask and no Pallas
kernel, so the port's is plain PyTorch too (:func:`_attention`).  The text
tower is the Flax module forward (:class:`SentenceEncoderModule`) over the
``bge-base-en-v1.5`` tree, projected into the image tower's space, as the
JAX package runs it (``text_module.apply``, not the fused trunk).  Scores
are SigLIP's pairwise logits, ``exp(logit_scale) * <i, t> + logit_bias``.

Weights are a seeded random init at the checkpoint's shapes
(:func:`init_vision_params`) or the JAX package's trees carried across
(:func:`from_jax_vision_params`, :meth:`MultimodalEncoder.from_jax`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from pathway_tpu_torch.device import resolve_device
from pathway_tpu_torch.models.encoder import (
    SentenceEncoderModule,
    _to_numpy,
    config_for,
    init_params,
)
from pathway_tpu_torch.models.tokenizer import (
    bucket_batch,
    bucket_seq_len,
    load_tokenizer,
    pad_batch,
)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch: int = 16
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    proj_dim: int = 768
    dtype: Any = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


VISION_PRESETS: dict[str, tuple[VisionConfig, str]] = {
    # (vision tower, text tower preset name)
    "siglip-base-patch16-224": (VisionConfig(), "bge-base-en-v1.5"),
    "siglip-so400m-patch14-384": (
        VisionConfig(
            image_size=384, patch=14, hidden=1152, layers=27, heads=16,
            intermediate=4304, proj_dim=1152,
        ),
        "bge-base-en-v1.5",
    ),
    "pw-tiny-siglip": (
        VisionConfig(
            image_size=32, patch=8, hidden=64, layers=2, heads=4,
            intermediate=128, proj_dim=32, dtype=torch.float32,
        ),
        "all-MiniLM-L6-v2",
    ),
}


def vision_config_for(model_name: str) -> tuple[VisionConfig, str]:
    if model_name in VISION_PRESETS:
        return VISION_PRESETS[model_name]
    raise ValueError(
        f"unknown multimodal model {model_name!r}; presets: "
        f"{sorted(VISION_PRESETS)}"
    )


_F32_LEAVES = ("logit_scale", "logit_bias")  # the SigLIP head stays in f32


def init_vision_params(cfg: VisionConfig, seed: int = 0, device=None) -> dict:
    """Stacked ``[layers, ...]`` pre-LN ViT parameters, made on ``device``
    with one ``torch.Generator``: the JAX tree's names, shapes, dtypes and
    scales (normal / sqrt(fan_in), LayerNorm scale one, biases zero,
    ``logit_scale = log 10`` and ``logit_bias = -10`` in f32).  The bits
    differ from the JAX package's for the same seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    H, F_, L = cfg.hidden, cfg.intermediate, cfg.layers
    pdim = cfg.patch * cfg.patch * 3

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    return {
        "patch_k": init((pdim, H), pdim),
        "patch_b": full((H,), 0.0),
        "pos": init((cfg.n_patches, H), H),
        "final_ln_s": full((H,), 1.0),
        "final_ln_b": full((H,), 0.0),
        "proj": init((H, cfg.proj_dim), H),
        "layers": {
            "ln0_s": full((L, H), 1.0),
            "ln0_b": full((L, H), 0.0),
            "ln1_s": full((L, H), 1.0),
            "ln1_b": full((L, H), 0.0),
            "qkv_k": init((L, H, 3 * H), H),
            "qkv_b": full((L, 3 * H), 0.0),
            "out_k": init((L, H, H), H),
            "out_b": full((L, H), 0.0),
            "ff1_k": init((L, H, F_), H),
            "ff1_b": full((L, F_), 0.0),
            "ff2_k": init((L, F_, H), F_),
            "ff2_b": full((L, H), 0.0),
        },
        "logit_scale": torch.tensor(math.log(10.0), dtype=torch.float32, device=device),
        "logit_bias": torch.tensor(-10.0, dtype=torch.float32, device=device),
    }


def from_jax_vision_params(tree, cfg: VisionConfig, device) -> dict:
    """The port's tree from the JAX package's (nested dicts of arrays, e.g.
    ``jax.device_get`` output), on ``device``: every leaf in ``cfg.dtype``
    but the SigLIP head's two scalars, which stay f32 as in the JAX tree."""
    device = resolve_device(device)

    def convert(node, name=""):
        if hasattr(node, "items"):
            return {k: convert(v, k) for k, v in node.items()}
        dtype = torch.float32 if name in _F32_LEAVES else cfg.dtype
        return torch.from_numpy(np.array(node, np.float32)).to(device=device, dtype=dtype)

    return convert(tree)


def _ln(x, scale, bias, eps: float = 1e-6):
    """The image tower's LayerNorm: f32 statistics (the mean, then the
    variance of the centred values), normalised and cast to ``x.dtype``
    before ``* scale + bias``, which then runs in that dtype.  Not the
    encoder's ``_ln``."""
    x32 = x.float()
    m = x32.mean(-1, keepdim=True)
    v = (x32 - m).square().mean(-1, keepdim=True)
    y = ((x32 - m) * torch.rsqrt(v + eps)).to(x.dtype)
    return y * scale + bias


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, S, S, 3]`` channel-last images → ``[B, N, patch*patch*3]``
    patch vectors, each row-major over (row in the patch, column in the
    patch, channel).  Rows and columns past the last whole patch are
    dropped, as a stride-``patch`` convolution without padding drops them
    (``siglip-so400m-patch14-384``: 27 patches of 14 over 384 pixels); the
    JAX package's reshape raises on such a size instead."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images[:, : gh * patch, : gw * patch].reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _attention(q, k, v):
    """Unmasked multi-head attention of ``[B, N, heads, D]`` q, k, v, as the
    JAX package's einsums compute it: the products summed in f32 and
    divided by sqrt(D) after the product, an f32 softmax cast back to the
    activation dtype, and the context product in that dtype.  Returns
    ``[B, N, heads*D]``."""
    B, N, heads, D = q.shape
    scores = torch.matmul(q.float().transpose(1, 2), k.float().permute(0, 2, 3, 1)) / math.sqrt(D)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)  # [B, heads, N, N]
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, N, heads * D)


def vision_forward(tree, images, cfg: VisionConfig):
    """``[B, S, S, 3]`` float images → L2-normalised ``[B, proj_dim]`` f32."""
    B = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg.patch)  # [B, N, pdim]
    x = x @ tree["patch_k"] + tree["patch_b"] + tree["pos"][None, :, :]
    N, H, heads = cfg.n_patches, cfg.hidden, cfg.heads
    D = H // heads
    layers = tree["layers"]
    for i in range(cfg.layers):
        lp = {name: w[i] for name, w in layers.items()}
        h = _ln(x, lp["ln0_s"], lp["ln0_b"])
        qkv = h @ lp["qkv_k"] + lp["qkv_b"]  # [B, N, 3H]
        q, k, v = (t.reshape(B, N, heads, D) for t in qkv.split(H, dim=-1))
        x = x + _attention(q, k, v) @ lp["out_k"] + lp["out_b"]
        h = _ln(x, lp["ln1_s"], lp["ln1_b"])
        h = F.gelu(h @ lp["ff1_k"] + lp["ff1_b"], approximate="tanh")
        x = x + h @ lp["ff2_k"] + lp["ff2_b"]
    x = _ln(x, tree["final_ln_s"], tree["final_ln_b"])
    pooled = x.mean(dim=1)  # [B, H]
    emb = (pooled @ tree["proj"]).float()
    return emb / (torch.linalg.norm(emb, dim=1, keepdim=True) + 1e-12)


def pairwise_logits(img_emb, txt_emb, tree):
    """SigLIP pairwise sigmoid logits: ``exp(logit_scale) * <i, t> + logit_bias``."""
    return torch.exp(tree["logit_scale"]) * (img_emb @ txt_emb.T) + tree["logit_bias"]


def text_forward(module, proj, ids, mask):
    """The text tower: the sentence embedding of ``module`` (already
    L2-normalised) through ``proj`` into the shared space, normalised again."""
    emb = module(ids, mask) @ proj
    return emb / (torch.linalg.norm(emb, dim=1, keepdim=True) + 1e-12)


class MultimodalEncoder:
    """Image + text → one shared embedding space, batched on the device.

    Images go through :func:`vision_forward` in batch buckets of at most
    ``max_batch``; texts through the text tower (:func:`text_forward`) at
    one sequence bucket for the longest text.  Runs on ``cuda:0`` unless
    ``device`` names another device; without a card and without
    ``device`` it raises."""

    def __init__(self, model_name: str = "siglip-base-patch16-224", seed: int = 0,
                 max_batch: int = 256, device=None):
        self.device = resolve_device(device)
        self.model_name = model_name
        vcfg, text_preset = vision_config_for(model_name)
        self.vision_config = vcfg
        self.text_config = config_for(text_preset)
        self.max_batch = max_batch
        gen = torch.Generator().manual_seed(seed + 2)
        text_proj = torch.randn((self.text_config.hidden, vcfg.proj_dim), generator=gen)
        self.set_params(
            init_vision_params(vcfg, seed, self.device),
            init_params(self.text_config, seed + 1),
            text_proj / math.sqrt(self.text_config.hidden),
        )
        self.tokenizer = load_tokenizer(
            text_preset, self.text_config.vocab_size, self.text_config.max_len
        )

    def set_params(self, params: dict, text_params, text_proj) -> None:
        """Replace the weights: the port's image tower tree, the text
        tower's Flax-structured tree and the ``[text hidden, proj_dim]``
        projection."""
        self.params = params
        self.text_params = _to_numpy(text_params)
        self.text_module = SentenceEncoderModule(self.text_config, self.text_params, self.device)
        self.text_proj = torch.tensor(np.asarray(text_proj, np.float32), device=self.device)

    def from_jax(self, params, text_params, text_proj) -> None:
        """Take the JAX encoder's three trees (``params``, ``text_params``,
        ``text_proj``, as numpy arrays, e.g. after ``jax.device_get``)."""
        self.set_params(
            from_jax_vision_params(params, self.vision_config, self.device), text_params, text_proj
        )

    @property
    def dimensions(self) -> int:
        return self.vision_config.proj_dim

    def prepare_images(self, images) -> np.ndarray:
        """The host side of :meth:`embed_images`: ``[B, S, S, 3]`` (or one
        ``[S, S, 3]``) uint8 or float images → f32 in ``[-1, 1]`` at the
        tower's size (uint8 over 255, then ``* 2 - 1``, then a bilinear
        resize where the size differs)."""
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None, ...]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32) * 2.0 - 1.0  # SigLIP-style [-1, 1]
        S = self.vision_config.image_size
        if arr.shape[1] != S or arr.shape[2] != S:
            arr = _resize_bilinear(arr, S)
        return arr

    def embed_images(self, images) -> np.ndarray:
        """``[B, S, S, 3]`` uint8 or float images → ``[B, proj_dim]`` f32."""
        arr = self.prepare_images(images)
        S = self.vision_config.image_size
        out = []
        with torch.inference_mode():
            for i in range(0, len(arr), self.max_batch):
                chunk = arr[i : i + self.max_batch]
                b = bucket_batch(len(chunk), self.max_batch)
                padded = np.zeros((b, S, S, 3), np.float32)
                padded[: len(chunk)] = chunk
                emb = vision_forward(self.params, torch.from_numpy(padded).to(self.device), self.vision_config)
                out.append(emb.cpu().numpy()[: len(chunk)])
        return np.concatenate(out, axis=0)

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), np.float32)
        id_lists = [self.tokenizer.encode(t or "") for t in texts]
        longest = max(len(x) for x in id_lists)
        seq = bucket_seq_len(min(longest, self.text_config.max_len))
        out = []
        with torch.inference_mode():
            for i in range(0, len(id_lists), self.max_batch):
                chunk = id_lists[i : i + self.max_batch]
                b = bucket_batch(len(chunk), self.max_batch)
                ids, mask = pad_batch(chunk + [[0]] * (b - len(chunk)), seq)
                emb = text_forward(
                    self.text_module, self.text_proj,
                    torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device),
                )
                out.append(emb.cpu().numpy()[: len(chunk)])
        return np.concatenate(out, axis=0)

    def score(self, images, texts: list[str]) -> np.ndarray:
        """Pairwise sigmoid logits ``[n_images, n_texts]``."""
        ie = torch.from_numpy(self.embed_images(images)).to(self.device)
        te = torch.from_numpy(self.embed_texts(texts)).to(self.device)
        with torch.inference_mode():
            return pairwise_logits(ie, te, self.params).cpu().numpy()


def _resize_bilinear(arr: np.ndarray, size: int) -> np.ndarray:
    """Minimal bilinear resize to ``[B, size, size, 3]`` (host-side; stdlib
    only — Pillow is not a dependency)."""
    B, H, W, C = arr.shape
    ys = np.linspace(0.0, H - 1.0, size)
    xs = np.linspace(0.0, W - 1.0, size)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    top = arr[:, y0][:, :, x0] * (1 - wx) + arr[:, y0][:, :, x1] * wx
    bot = arr[:, y1][:, :, x0] * (1 - wx) + arr[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


@functools.lru_cache(maxsize=4)
def shared_multimodal_encoder(
    model_name: str = "siglip-base-patch16-224", device=None,
) -> MultimodalEncoder:
    """One ``MultimodalEncoder`` per (model, device) in the process."""
    return MultimodalEncoder(model_name, device=device)
