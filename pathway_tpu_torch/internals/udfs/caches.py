"""UDF result caches (parity: internals/udfs/caches.py:23-141).

``DiskCache`` persists through the persistence layer's cached-object storage
(the reference routes it through engine persistence,
``src/persistence/cached_object_storage.rs``).  The port has no persistence
layer before slice H4, so it raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import pickle
from typing import Any, Callable


class CacheStrategy:
    def wrap(self, fun: Callable) -> Callable:
        raise NotImplementedError

    @staticmethod
    def _cache_key(fun: Callable, args, kwargs) -> str:
        payload = pickle.dumps((getattr(fun, "__name__", "fn"), args, tuple(sorted(kwargs.items()))))
        return hashlib.blake2b(payload, digest_size=16).hexdigest()


class InMemoryCache(CacheStrategy):
    def __init__(self):
        self._store: dict[str, Any] = {}

    def wrap(self, fun: Callable) -> Callable:
        if asyncio.iscoroutinefunction(fun):

            @functools.wraps(fun)
            async def async_wrapper(*args, **kwargs):
                key = self._cache_key(fun, args, kwargs)
                if key not in self._store:
                    self._store[key] = await fun(*args, **kwargs)
                return self._store[key]

            return async_wrapper

        @functools.wraps(fun)
        def wrapper(*args, **kwargs):
            key = self._cache_key(fun, args, kwargs)
            if key not in self._store:
                self._store[key] = fun(*args, **kwargs)
            return self._store[key]

        return wrapper


class DiskCache(CacheStrategy):
    """Persists through the persistence layer, which the port has not
    taken yet: constructing one raises until slice H4 brings it."""

    def __init__(self, name: str | None = None, size_limit: int | None = None):
        raise NotImplementedError(
            "DiskCache needs the persistence layer, which the port brings in "
            "slice H4 (engine/persistence.py); use InMemoryCache until then"
        )


DefaultCache = DiskCache
