"""UDF system: ``@pw.udf`` with sync/async executors, caching, retries.

Parity target: ``python/pathway/internals/udfs/__init__.py``
(UDF/UDFFunction, :65,:211), ``executors.py`` (auto/sync/async), ``caches.py``
(CacheStrategy/DiskCache/InMemoryCache), ``retries.py``.

TPU note: sync UDFs are evaluated per-row host-side like the reference's
GIL-batched path; array-valued deterministic UDFs over jax are the escape
hatch the xpack embedders use (they batch row deltas into device arrays —
see pathway_tpu/utils/batching.py).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnExpression,
)
from pathway_tpu_torch.internals.udfs.caches import (
    CacheStrategy,
    DefaultCache,
    DiskCache,
    InMemoryCache,
)
from pathway_tpu_torch.internals.udfs.executors import (
    Executor,
    async_executor,
    async_options,
    auto_executor,
    fully_async_executor,
    sync_executor,
)
from pathway_tpu_torch.internals.udfs.retries import (
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
)

__all__ = [
    "udf",
    "UDF",
    "auto_executor",
    "async_executor",
    "async_options",
    "sync_executor",
    "fully_async_executor",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "InMemoryCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "coerce_async",
    "with_cache_strategy",
    "with_capacity",
    "with_retry_strategy",
    "with_timeout",
]


class UDF:
    """Base class for user-defined functions (subclass and define __wrapped__)."""

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or auto_executor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        self.__wrapped__: Callable | None = getattr(self, "__wrapped__", None)

    def _resolve_return_type(self, fun: Callable) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            hints = typing.get_type_hints(fun)
            return hints.get("return")
        except Exception:
            return None

    def _wrapped_fun(self) -> Callable:
        fun = self.__wrapped__
        if fun is None:
            raise TypeError("UDF subclass must define __wrapped__")
        if self.cache_strategy is not None:
            fun = self.cache_strategy.wrap(fun)
        return fun

    def as_async_callable(self) -> Callable:
        """The UDF's function as a directly-awaitable callable with its
        configured cache strategy, retry strategy, capacity, and timeout
        applied — for host-side callers (RAG handlers) that invoke the
        model outside a dataflow expression."""
        fun = self._wrapped_fun()
        fun = self.executor.wrap_async(fun)
        return coerce_async(fun)

    def __call__(self, *args, **kwargs) -> ColumnExpression:
        fun = self._wrapped_fun()
        ret = self._resolve_return_type(self.__wrapped__)
        if asyncio.iscoroutinefunction(self.__wrapped__) or getattr(
            self.executor, "is_async", False
        ):
            fun = self.executor.wrap_async(fun)
            return AsyncApplyExpression(
                fun,
                ret,
                *args,
                _propagate_none=self.propagate_none,
                _deterministic=self.deterministic,
                **kwargs,
            )
        fun = self.executor.wrap_sync(fun)
        return ApplyExpression(
            fun,
            ret,
            *args,
            _propagate_none=self.propagate_none,
            _deterministic=self.deterministic,
            _max_batch_size=self.max_batch_size,
            **kwargs,
        )


class _FunctionUDF(UDF):
    def __init__(self, fun: Callable, **kwargs):
        super().__init__(**kwargs)
        self.__wrapped__ = fun
        functools.update_wrapper(self, fun)


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
):
    r"""``@pw.udf`` — turn a Python function into a column-expression builder.

    Example:

    >>> import pathway_tpu_torch as pw
    >>> @pw.udf
    ... def shout(s: str) -> str:
    ...     return s.upper()
    >>> t = pw.debug.table_from_markdown('w\nhi\nyo')
    >>> pw.debug.compute_and_print(t.select(loud=shout(pw.this.w)), include_id=False)
    loud
    HI
    YO
    """

    def wrapper(f: Callable) -> _FunctionUDF:
        return _FunctionUDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )

    if fun is not None:
        return wrapper(fun)
    return wrapper


# helpers mirroring pathway.udfs module-level functions
def coerce_async(fun: Callable) -> Callable:
    if asyncio.iscoroutinefunction(fun):
        return fun

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return fun(*args, **kwargs)

    return wrapper


def with_cache_strategy(fun: Callable, cache_strategy: CacheStrategy) -> Callable:
    return cache_strategy.wrap(fun)


def with_capacity(fun: Callable, capacity: int) -> Callable:
    fun = coerce_async(fun)
    semaphore = asyncio.Semaphore(capacity)

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        async with semaphore:
            return await fun(*args, **kwargs)

    return wrapper


def with_retry_strategy(fun: Callable, retry_strategy: AsyncRetryStrategy) -> Callable:
    fun = coerce_async(fun)

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await retry_strategy.invoke(fun, *args, **kwargs)

    return wrapper


def with_timeout(fun: Callable, timeout: float) -> Callable:
    fun = coerce_async(fun)

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(fun(*args, **kwargs), timeout=timeout)

    return wrapper
