"""Null sink (parity: python/pathway/io/null; NullWriter data_storage.rs:1479)."""

from __future__ import annotations

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils


def write(table: Table, *, name: str | None = None, **kwargs) -> None:
    _utils.register_output(table, lambda key, row, time, diff: None, name=name or "null")
