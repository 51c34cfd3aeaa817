"""Mock components for testing (parity: xpacks/llm/tests/mocks.py:5-25).

Mock the *components*, not the engine — pipelines exercise the real
dataflow/index path with deterministic fakes.
"""

from __future__ import annotations

import hashlib

import numpy as np

from pathway_tpu_torch.internals.udfs import UDF


class FakeChatModel(UDF):
    """Always answers 'Text' (reference FakeChatModel)."""

    def __init__(self):
        super().__init__()

        def chat(messages, **kwargs) -> str:
            return "Text"

        self.__wrapped__ = chat

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True


class IdentityMockChat(UDF):
    """Echoes 'model: last message content'."""

    def __init__(self):
        super().__init__()

        def chat(messages, model="mock", **kwargs) -> str:
            from pathway_tpu_torch.engine.types import Json

            if isinstance(messages, Json):
                messages = messages.value
            if isinstance(messages, str):
                content = messages
            else:
                content = messages[-1].get("content", "") if messages else ""
            return f"{model}: {content}"

        self.__wrapped__ = chat


def fake_embeddings_model_fn(text: str) -> np.ndarray:
    """Deterministic 8-dim embedding from a text hash (reference
    fake_embeddings_model)."""
    h = hashlib.blake2b((text or "").encode(), digest_size=16).digest()
    v = np.frombuffer(h, dtype=np.uint8).astype(np.float32)[:8]
    n = np.linalg.norm(v) + 1e-9
    return v / n


class FakeEmbeddings(UDF):
    def __init__(self, dims: int = 8):
        super().__init__(deterministic=True)
        self.dims = dims

        def embed(text: str) -> np.ndarray:
            return fake_embeddings_model_fn(text)

        self.__wrapped__ = embed

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.dims


fake_embeddings_model = FakeEmbeddings()
