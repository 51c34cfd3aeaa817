"""Plaintext connector (parity: python/pathway/io/plaintext)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(
    path: str,
    *,
    mode: str = "streaming",
    object_pattern: str = "*",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    return _fs.read(
        path,
        format="plaintext",
        debug_data=debug_data,
        mode=mode,
        object_pattern=object_pattern,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
    )
