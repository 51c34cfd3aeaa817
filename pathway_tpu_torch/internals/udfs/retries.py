"""Async retry strategies (parity: internals/udfs/retries.py, 116 LoC)."""

from __future__ import annotations

import asyncio
import random
from typing import Any, Callable, Iterator


class AsyncRetryStrategy:
    async def invoke(self, fun: Callable, /, *args, **kwargs) -> Any:
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fun: Callable, /, *args, **kwargs) -> Any:
        return await fun(*args, **kwargs)


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1_000,
        backoff_factor: float = 2,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1_000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1_000

    def delays(self) -> "Iterator[float]":
        """The backoff schedule in seconds, one entry per retry (jittered).

        Shared by the async ``invoke`` below and by synchronous retriers
        (the comm mesh's link-reconnect loop, ``engine/comm.py``) so the
        whole codebase has exactly one backoff policy implementation.
        """
        delay = self.initial_delay
        for _ in range(self.max_retries):
            yield delay + random.random() * self.jitter
            delay *= self.backoff_factor

    async def invoke(self, fun: Callable, /, *args, **kwargs) -> Any:
        schedule = self.delays()
        for attempt in range(self.max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except asyncio.CancelledError:
                raise
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(next(schedule))
        raise RuntimeError("unreachable")


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1_000):
        super().__init__(
            max_retries=max_retries,
            initial_delay=delay_ms,
            backoff_factor=1,
            jitter_ms=0,
        )
