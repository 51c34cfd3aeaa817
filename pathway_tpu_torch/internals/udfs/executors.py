"""UDF executors: auto / sync / async / fully_async.

Parity target: ``python/pathway/internals/udfs/executors.py``
(:36-154).  Async semantics follow dataflow.rs:1899-1937: all rows of a batch
are in flight concurrently; the epoch acts as a barrier (results re-enter at
the same timestamp).  ``fully_async_executor`` is the AsyncTransformer-style
non-blocking variant.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable

from pathway_tpu_torch.internals.udfs.retries import AsyncRetryStrategy


class Executor:
    is_async = False

    def wrap_sync(self, fun: Callable) -> Callable:
        return fun

    def wrap_async(self, fun: Callable) -> Callable:
        return fun


class AutoExecutor(Executor):
    """Chooses sync for plain functions, async for coroutine functions."""


def auto_executor() -> Executor:
    return AutoExecutor()


class SyncExecutor(Executor):
    is_async = False


def sync_executor() -> Executor:
    return SyncExecutor()


class AsyncExecutor(Executor):
    is_async = True

    def __init__(
        self,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy

    def wrap_async(self, fun: Callable) -> Callable:
        from pathway_tpu_torch.internals.udfs import (
            coerce_async,
            with_capacity,
            with_retry_strategy,
            with_timeout,
        )

        fun = coerce_async(fun)
        if self.retry_strategy is not None:
            fun = with_retry_strategy(fun, self.retry_strategy)
        if self.timeout is not None:
            fun = with_timeout(fun, self.timeout)
        if self.capacity is not None:
            fun = with_capacity(fun, self.capacity)
        return fun


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> Executor:
    return AsyncExecutor(capacity=capacity, timeout=timeout, retry_strategy=retry_strategy)


class FullyAsyncExecutor(AsyncExecutor):
    """Results arrive at later epochs instead of blocking the batch."""

    def __init__(self, *, autocommit_duration_ms: int | None = 100, **kwargs):
        super().__init__(**kwargs)
        self.autocommit_duration_ms = autocommit_duration_ms


def fully_async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    autocommit_duration_ms: int | None = 100,
) -> Executor:
    return FullyAsyncExecutor(
        capacity=capacity,
        timeout=timeout,
        retry_strategy=retry_strategy,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def async_options(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    cache_strategy=None,
):
    """Decorator applying async options to a plain function, returning an
    AWAITABLE callable (parity: udfs/executors.py:286 — the reference
    composes the with_* wrappers, not a UDF; use ``@pw.udf`` with
    ``executor=async_executor(...)`` for the column-expression form)."""

    def decorator(fun):
        from pathway_tpu_torch.internals.udfs import (
            coerce_async,
            with_cache_strategy,
            with_capacity,
            with_retry_strategy,
            with_timeout,
        )

        wrapped = coerce_async(fun)
        if timeout is not None:
            wrapped = with_timeout(wrapped, timeout)
        if retry_strategy is not None:
            wrapped = with_retry_strategy(wrapped, retry_strategy)
        if capacity is not None:
            wrapped = with_capacity(wrapped, capacity)
        if cache_strategy is not None:
            wrapped = with_cache_strategy(wrapped, cache_strategy)
        return wrapped

    return decorator
