"""UDF result caches (parity: internals/udfs/caches.py:23-141).

``DiskCache`` persists through the persistence layer's cached-object storage
(the reference routes it through engine persistence,
``src/persistence/cached_object_storage.rs``); here it writes one pickle per
key under the persistence root or a local cache dir.

A copy of ``pathway_tpu/internals/udfs/caches.py``.  One difference: a
``torch.Tensor`` result (or a tuple or list holding one) is stored, and
returned, as the host numpy array the engine turns it into
(``internals/dtype.py``), so a cache entry never pickles a device tensor
and a hit returns what a miss does.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import os
import pickle
from typing import Any, Callable


def _host(value: Any) -> Any:
    """``value`` with every ``torch.Tensor`` in it (at any depth of tuples
    and lists) turned into the host numpy array the engine stores for it."""
    import torch

    if isinstance(value, torch.Tensor):
        from pathway_tpu_torch.internals.dtype import tensor_to_numpy

        return tensor_to_numpy(value)
    if isinstance(value, (tuple, list)):
        return type(value)(_host(v) for v in value)
    return value


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
    def __init__(self, name: str | None = None, size_limit: int | None = None):
        self.name = name
        self.size_limit = size_limit

    @property
    def _dir(self) -> str:
        # resolved per call: the current run's persistence root wins
        # (context-local, so concurrent runs each see their own), then the
        # env override, then a local default
        from pathway_tpu_torch.engine import persistence as pz
        from pathway_tpu_torch.internals.config import env_str

        root = (
            pz.active_root()
            or env_str("PATHWAY_PERSISTENT_STORAGE")
            or ".pathway_tpu_cache"
        )
        return os.path.join(root, "udf_cache", self.name or "default")

    def _path(self, key: str) -> str:
        return os.path.join(self._dir, key + ".pkl")

    def _get(self, key: str):
        path = self._path(key)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return True, pickle.load(f)
        return False, None

    def _put(self, key: str, value: Any) -> None:
        value = _host(value)
        os.makedirs(self._dir, exist_ok=True)
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f)

    def wrap(self, fun: Callable) -> Callable:
        if asyncio.iscoroutinefunction(fun):

            @functools.wraps(fun)
            async def async_wrapper(*args, **kwargs):
                key = self._cache_key(fun, args, kwargs)
                hit, value = self._get(key)
                if hit:
                    return value
                value = _host(await fun(*args, **kwargs))
                self._put(key, value)
                return value

            return async_wrapper

        @functools.wraps(fun)
        def wrapper(*args, **kwargs):
            key = self._cache_key(fun, args, kwargs)
            hit, value = self._get(key)
            if hit:
                return value
            value = _host(fun(*args, **kwargs))
            self._put(key, value)
            return value

        return wrapper


DefaultCache = DiskCache
