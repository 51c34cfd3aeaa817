"""Embedders (parity: xpacks/llm/embedders.py:85-401).

A copy of ``pathway_tpu/xpacks/llm/embedders.py`` over the port's device
layer.  ``SentenceTransformerEmbedder`` is the device path: the fused
bi-encoder (``models/encoder.py``, its attention the CUDA kernel) behind
an ``AsyncMicroBatcher`` on the device's shared executor, so every
concurrently-streaming row of an epoch lands in one padded device batch.
Each embedder runs on ``cuda:0`` unless ``device`` names another device;
without a card and without ``device`` it raises.  API-based embedders
(OpenAI/LiteLLM/Gemini) keep reference parity and are gated on their
client packages.
"""

from __future__ import annotations

import asyncio
from typing import Any

import numpy as np

from pathway_tpu_torch.device import get_default_executor
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor
from pathway_tpu_torch.utils.batching import AsyncMicroBatcher


class BaseEmbedder(UDF):
    def get_embedding_dimension(self, **kwargs) -> int:
        """Embed a probe string and measure (reference embedders.py)."""
        result = self.__wrapped__("pathway_tpu_torch probe")
        if asyncio.iscoroutine(result):
            result = asyncio.run(result)
        return len(result)

    def __call__(self, input: ColumnExpression | Any = None, **kwargs) -> ColumnExpression:
        if input is None:
            raise TypeError("embedder requires an input expression")
        return super().__call__(input, **kwargs)


class SentenceTransformerEmbedder(BaseEmbedder):
    """Device-native analog of the reference's SentenceTransformer wrapper
    (embedders.py:~301): same constructor surface, but ``model`` resolves to
    the port's fused encoder (``shared_sentence_encoder``).  ``device``
    ``"auto"`` is the first card (or an error without one); with ``mesh``
    the encoder runs on the mesh's device.
    """

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        call_kwargs: dict = {},
        device: str = "auto",
        *,
        max_batch_size: int = 256,
        mesh=None,
        **init_kwargs,
    ):
        super().__init__(executor=async_executor(), deterministic=True)
        self.model_name = model
        if mesh is not None:
            # long-context mode: the sequence axis shards over the mesh
            # (ring attention), so documents far beyond the model's
            # max_len embed without truncation
            from pathway_tpu_torch.models.long_context import (
                shared_long_context_encoder,
            )

            self._encoder = shared_long_context_encoder(model, mesh)
        else:
            from pathway_tpu_torch.models.encoder import shared_sentence_encoder

            self._encoder = shared_sentence_encoder(
                model, device=None if device == "auto" else device
            )
        self._batcher = AsyncMicroBatcher(
            self._process_batch,
            max_batch_size=max_batch_size,
            executor=get_default_executor(self._encoder.device),
            name=f"embedder:{model}",
        )

        async def embed(text: str) -> np.ndarray:
            return await self._batcher.submit(text if text is not None else "")

        embed.__name__ = f"sentence_transformer:{model}"
        self.__wrapped__ = embed

    def _process_batch(self, texts: list[str]) -> list[np.ndarray]:
        vectors = self._encoder.encode(texts)
        return [vectors[i] for i in range(len(texts))]

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.dimensions


# the device default; the reference aliases its default embedder similarly
SentenceTransformerTask = SentenceTransformerEmbedder


class OpenAIEmbedder(BaseEmbedder):
    """OpenAI API embedder (parity: embedders.py:85). Gated on `openai`."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "text-embedding-3-small",
        retry_strategy=None,
        cache_strategy=None,
        **openai_kwargs,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(openai_kwargs)

        async def embed(input: str, **kwargs) -> np.ndarray:
            import openai  # gated

            client = openai.AsyncOpenAI()
            params = {**self.kwargs, **kwargs, "model": self.model}
            ret = await client.embeddings.create(input=[input or "."], **params)
            return np.array(ret.data[0].embedding)

        self.__wrapped__ = embed


class LiteLLMEmbedder(BaseEmbedder):
    """LiteLLM embedder (parity: embedders.py). Gated on `litellm`."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = None,
        retry_strategy=None,
        cache_strategy=None,
        **llmlite_kwargs,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(llmlite_kwargs)

        async def embed(input: str, **kwargs) -> np.ndarray:
            import litellm  # gated

            ret = await litellm.aembedding(
                input=[input or "."], model=self.model, **{**self.kwargs, **kwargs}
            )
            return np.array(ret.data[0]["embedding"])

        self.__wrapped__ = embed


class GeminiEmbedder(BaseEmbedder):
    """Gemini embedder (parity: embedders.py:~401). Gated on google client."""

    def __init__(
        self,
        model: str | None = "models/embedding-001",
        capacity: int | None = None,
        retry_strategy=None,
        cache_strategy=None,
        **gemini_kwargs,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(gemini_kwargs)

        async def embed(input: str, **kwargs) -> np.ndarray:
            import google.generativeai as genai  # gated

            ret = genai.embed_content(
                model=self.model, content=input or ".", **{**self.kwargs, **kwargs}
            )
            return np.array(ret["embedding"])

        self.__wrapped__ = embed


class MultimodalEmbedder(BaseEmbedder):
    """SigLIP-class image+text embedder into one shared space.

    Beyond-reference capability named by BASELINE.md's multimodal RAG
    config (the reference's embedders are text-only API/torch wrappers,
    ``xpacks/llm/embedders.py:85-401``).  Both towers are the port's
    ``MultimodalEncoder`` (``models/vision.py``), on ``cuda:0`` unless
    ``device`` names another device; text rows and image rows land in the
    same ``proj_dim`` space, so one ``DocumentStore``/sharded index serves
    a mixed corpus.

    Accepted inputs per row: ``str`` (text), ``np.ndarray`` (HWC image),
    or ``bytes`` — a ``.npy`` serialization, or any image format Pillow
    can open when Pillow is importable.
    """

    def __init__(
        self,
        model: str = "siglip-base-patch16-224",
        *,
        max_batch_size: int = 64,
        device=None,
        **init_kwargs,
    ):
        super().__init__(executor=async_executor(), deterministic=True)
        from pathway_tpu_torch.models.vision import shared_multimodal_encoder

        self.model_name = model
        self._encoder = shared_multimodal_encoder(model, device=device)
        from pathway_tpu_torch.device import stack_rows

        executor = get_default_executor(self._encoder.device)
        self._text_batcher = AsyncMicroBatcher(
            lambda texts: list(self._encoder.embed_texts(texts)),
            max_batch_size=max_batch_size,
            executor=executor,
            name=f"embedder:{model}:text",
        )
        # stack_rows (not np.stack): a dtype/shape mix in one coalesced
        # image batch fails loudly instead of silently upcasting
        self._image_batcher = AsyncMicroBatcher(
            lambda imgs: list(self._encoder.embed_images(stack_rows(imgs)[0])),
            max_batch_size=max_batch_size,
            executor=executor,
            name=f"embedder:{model}:image",
        )

        async def embed(input: Any = None, **kwargs) -> np.ndarray:
            img = _decode_image(input, self._encoder.vision_config.image_size)
            if img is not None:
                return await self._image_batcher.submit(img)
            return await self._text_batcher.submit(
                input if isinstance(input, str) else str(input or "")
            )

        embed.__name__ = f"multimodal:{model}"
        self.__wrapped__ = embed

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.dimensions


def _decode_image(value: Any, image_size: int) -> np.ndarray | None:
    """Best-effort decode of a row value into a ``[S, S, 3]`` f32 image;
    returns None for text rows.  Pre-resizes so ragged sources stack into
    one device batch."""
    from pathway_tpu_torch.models.vision import _resize_bilinear

    arr = None
    if isinstance(value, np.ndarray) and value.ndim >= 2:
        arr = value
    elif isinstance(value, bytes):
        import io

        try:
            loaded = np.load(io.BytesIO(value), allow_pickle=False)
            if isinstance(loaded, np.ndarray) and loaded.ndim >= 2:
                arr = loaded
        except Exception:
            try:
                from PIL import Image  # gated: Pillow is optional

                arr = np.asarray(Image.open(io.BytesIO(value)).convert("RGB"))
            except Exception:
                return None
    if arr is None:
        return None
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        return None
    # CHW layouts (channel-count leading, spatial dims trailing) → HWC
    if arr.shape[0] in (1, 3, 4) and arr.shape[-1] not in (1, 2, 3, 4):
        arr = arr.transpose(1, 2, 0)
    c = arr.shape[-1]
    if c == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif c == 2:  # e.g. gray+alpha: keep luminance, drop alpha
        arr = np.repeat(arr[..., :1], 3, axis=2)
    elif c > 3:
        arr = arr[..., :3]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    # keep [0, 1] floats: embed_images applies the [-1, 1] mapping once
    arr = arr.astype(np.float32)
    if arr.shape[0] != image_size or arr.shape[1] != image_size:
        arr = _resize_bilinear(arr[None, ...], image_size)[0]
    return arr
