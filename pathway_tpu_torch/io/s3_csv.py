"""Amazon S3 CSV connector (parity: python/pathway/io/s3_csv) —
``pw.io.s3.read`` specialized to csv."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import s3 as _s3
from pathway_tpu_torch.io._s3http import AwsS3Settings

__all__ = ["read"]


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    kwargs.pop("format", None)
    return _s3.read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        mode=mode,
        csv_settings=csv_settings,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        debug_data=debug_data,
        name=name,
        **kwargs,
    )
