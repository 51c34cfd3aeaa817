"""Shared helpers for the LLM xpack (parity: xpacks/llm/_utils.py)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.types import Json


def send_post_request(
    url: str, data: dict, headers: dict | None = None, timeout: int | None = None
):
    """POST JSON, raise on HTTP errors, return the parsed JSON response
    (parity: question_answering.py:870)."""
    import json as _json
    import urllib.request

    req = urllib.request.Request(
        url,
        data=_json.dumps(data).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return _json.loads(resp.read().decode())


def _coerce_sync(fn):
    import asyncio
    import functools

    if not asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return asyncio.run(fn(*args, **kwargs))

    return wrapper


def _extract_value(value: Any) -> Any:
    if isinstance(value, Json):
        return value.value
    return value


def _unwrap_udf(udf) -> Any:
    from pathway_tpu_torch.internals.udfs import UDF

    if isinstance(udf, UDF):
        return udf.__wrapped__
    return udf
