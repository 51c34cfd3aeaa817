"""Chat models (parity: xpacks/llm/llms.py:97-547).

A copy of ``pathway_tpu/xpacks/llm/llms.py``.  OpenAI/LiteLLM/Cohere chats
import their client packages at first use; ``HFPipelineChat`` runs a local
transformers pipeline when a model is cached.  ``JaxChat`` keeps its name,
so user programs run unchanged: it generates with the port's decoder
(``models/decoder.py``) through the continuous-batching scheduler, or the
static ``AsyncMicroBatcher`` path for ``top_k``/``repetition_penalty``.
``prompt_chat_single_qa`` mirrors the reference helper.  All chats are
async UDFs so concurrent rows of an epoch fan out together.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF, async_executor
import pathway_tpu_torch.internals.expression as expr_mod


class BaseChat(UDF):
    """Common surface: __call__(messages) where messages is a chat list."""

    def _accepts_call_arg(self, arg_name: str) -> bool:
        return True


def _messages_to_prompt(messages: Any) -> str:
    if isinstance(messages, Json):
        messages = messages.value
    if isinstance(messages, str):
        return messages
    if isinstance(messages, (list, tuple)):
        parts = []
        for m in messages:
            if isinstance(m, Json):
                m = m.value
            if isinstance(m, dict):
                parts.append(f"{m.get('role', 'user')}: {m.get('content', '')}")
            else:
                parts.append(str(m))
        return "\n".join(parts)
    return str(messages)


class OpenAIChat(BaseChat):
    """OpenAI chat (parity: llms.py:97). Gated on `openai`."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "gpt-3.5-turbo",
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

        async def chat(messages: Any, **kwargs) -> str | None:
            import openai  # gated

            client = openai.AsyncOpenAI()
            if isinstance(messages, Json):
                messages = messages.value
            if isinstance(messages, str):
                messages = [{"role": "user", "content": messages}]
            params = {"model": self.model, **self.kwargs, **kwargs}
            ret = await client.chat.completions.create(messages=messages, **params)
            return ret.choices[0].message.content

        self.__wrapped__ = chat


class LiteLLMChat(BaseChat):
    """LiteLLM chat (parity: llms.py). Gated on `litellm`."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = None,
        retry_strategy=None,
        cache_strategy=None,
        **litellm_kwargs,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(litellm_kwargs)

        async def chat(messages: Any, **kwargs) -> str | None:
            import litellm  # gated

            if isinstance(messages, Json):
                messages = messages.value
            if isinstance(messages, str):
                messages = [{"role": "user", "content": messages}]
            ret = await litellm.acompletion(
                model=self.model, messages=messages, **{**self.kwargs, **kwargs}
            )
            return ret.choices[0]["message"]["content"]

        self.__wrapped__ = chat


class CohereChat(BaseChat):
    """Cohere chat with citations (parity: llms.py:~547). Gated on `cohere`."""

    def __init__(
        self,
        capacity: int | None = None,
        model: str | None = "command",
        retry_strategy=None,
        cache_strategy=None,
        **cohere_kwargs,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity, retry_strategy=retry_strategy),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.kwargs = dict(cohere_kwargs)

        async def chat(messages: Any, documents=None, **kwargs) -> tuple:
            import cohere  # gated

            client = cohere.AsyncClient()
            ret = await client.chat(
                message=_messages_to_prompt(messages),
                model=self.model,
                documents=documents,
                **{**self.kwargs, **kwargs},
            )
            cited = [dict(c.__dict__) for c in (ret.citations or [])]
            return (ret.text, tuple(map(str, cited)))

        self.__wrapped__ = chat


class HFPipelineChat(BaseChat):
    """Local transformers pipeline chat (parity: llms.py HFPipelineChat).

    Works offline when the model is in the local HF cache — ``JaxChat``
    below is the port's serving path for the generation side.
    """

    def __init__(
        self,
        model: str | None = "gpt2",
        call_kwargs: dict = {},
        device: str = "cpu",
        **pipeline_kwargs,
    ):
        super().__init__()
        self.model = model
        self.call_kwargs = dict(call_kwargs)
        self.pipeline_kwargs = dict(pipeline_kwargs)
        self._pipeline = None

        def chat(messages: Any, **kwargs) -> str | None:
            pipe = self._get_pipeline()
            prompt = _messages_to_prompt(messages)
            out = pipe(prompt, **{**self.call_kwargs, **kwargs})
            text = out[0]["generated_text"]
            if isinstance(text, str) and text.startswith(prompt):
                text = text[len(prompt):]
            return text

        self.__wrapped__ = chat

    def _get_pipeline(self):
        if self._pipeline is None:
            import os

            os.environ.setdefault("HF_HUB_OFFLINE", "1")
            os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
            from transformers import pipeline  # gated offline

            self._pipeline = pipeline(
                "text-generation", model=self.model, **self.pipeline_kwargs
            )
        return self._pipeline

    def crop_to_max_prompt_size(self, text: str, max_tokens: int = 1024) -> str:
        return text[: max_tokens * 4]


class JaxChat(BaseChat):
    """Local chat on the port's decoder with a paged KV cache.

    The reference's local-serving story is a host-side torch pipeline
    (``xpacks/llm/llms.py:314`` HFPipelineChat; the Adaptive RAG template
    runs Mistral-7B-Instruct through it).  Here every row is a request of
    the process-wide ``GenerationScheduler`` of its model (chunked prefill
    and per-step admission into one device batch); a config with
    ``top_k`` or ``repetition_penalty`` goes through a static
    ``AsyncMicroBatcher`` over ``DecoderLM.generate_many`` instead.  A
    locally cached llama/mistral-family checkpoint is mapped in when
    present; otherwise seeded random weights keep shapes and FLOPs.
    ``device`` is the port's own: the decoder runs on ``cuda:0`` unless it
    names another device.
    """

    def __init__(
        self,
        model: str = "mistral-7b-instruct",
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        max_cache: int = 1024,
        max_batch: int = 32,
        capacity: int | None = None,
        cache_strategy=None,
        quantize: str | None = None,
        device=None,
    ):
        super().__init__(
            executor=async_executor(capacity=capacity),
            cache_strategy=cache_strategy,
        )
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.max_cache = max_cache
        self.max_batch = max_batch
        if quantize not in (None, "int8"):  # fail at config time, not first row
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.quantize = quantize
        self.device = device
        self._model = None
        self._init_lock = None
        self._batchers: dict[tuple, Any] = {}

        async def chat(messages: Any, **kwargs) -> str:
            import asyncio

            from pathway_tpu_torch.serving import generation

            if self._model is None:
                # first call builds the model; keep the loop free while it does,
                # and hold a lock so concurrent rows build it only once
                if self._init_lock is None:
                    self._init_lock = asyncio.Lock()
                async with self._init_lock:
                    if self._model is None:
                        self._model = await asyncio.to_thread(self._build_model)
            lm = self._model
            mnt = int(kwargs.get("max_tokens", self.max_new_tokens))
            temp = float(kwargs.get("temperature", self.temperature))
            # coerce BEFORE keying: 5 and 5.0 must share one batcher, and
            # a malformed kwarg should fail
            # here with a clear TypeError, not inside the batch worker
            top_k = kwargs.get("top_k")
            top_k = None if top_k is None else int(top_k)
            top_p = kwargs.get("top_p")
            top_p = None if top_p is None else float(top_p)
            min_p = kwargs.get("min_p")
            min_p = None if min_p is None else float(min_p)
            rep = kwargs.get("repetition_penalty")
            rep = None if rep is None else float(rep)
            # continuous batching: every sampling config shares ONE
            # scheduler batch (per-slot temp/top_p/min_p ride as data in
            # the decode step), so a new config never waits for a
            # static batch to drain.  top_k / repetition_penalty need
            # per-row history state the fixed-shape step doesn't carry —
            # those configs fall back to the static batcher below.
            if (
                generation.continuous_enabled()
                and top_k is None
                and rep is None
            ):
                sched = generation.shared_scheduler(
                    self.model, max_cache=self.max_cache,
                    quantize=self.quantize, device=self.device,
                )
                fut = sched.submit(
                    _messages_to_prompt(messages),
                    max_new_tokens=mnt,
                    temperature=temp,
                    top_p=top_p,
                    min_p=min_p,
                )
                return await asyncio.wrap_future(fut)
            bkey = (mnt, temp, top_k, top_p, min_p, rep)
            batcher = self._batchers.get(bkey)
            if batcher is None:
                from pathway_tpu_torch.utils.batching import AsyncMicroBatcher

                # one batcher per sampling config; generation is seconds
                # long, so batches run in a thread to keep the loop live
                batcher = AsyncMicroBatcher(
                    lambda prompts: lm.generate_many(
                        prompts,
                        max_new_tokens=mnt,
                        temperature=temp,
                        top_k=top_k,
                        top_p=top_p,
                        min_p=min_p,
                        repetition_penalty=rep,
                    ),
                    max_batch_size=self.max_batch,
                    flush_delay=0.01,
                    run_in_thread=True,
                )
                self._batchers[bkey] = batcher
            return await batcher.submit(_messages_to_prompt(messages))

        self.__wrapped__ = chat

    def _build_model(self):
        from pathway_tpu_torch.models.decoder import shared_decoder

        return shared_decoder(
            self.model, max_cache=self.max_cache, quantize=self.quantize,
            device=self.device,
        )

    def crop_to_max_prompt_size(self, text: str, max_tokens: int = 1024) -> str:
        return text[: max_tokens * 4]


def prompt_chat_single_qa(question: ColumnExpression) -> ColumnExpression:
    """Wrap a question column into a single-message chat (llms.py helper)."""
    from pathway_tpu_torch.internals import dtype as dt

    return expr_mod.ApplyExpression(
        lambda q: Json([{"role": "user", "content": q}]),
        dt.JSON,
        question,
    )
