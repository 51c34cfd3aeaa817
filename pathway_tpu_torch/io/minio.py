"""MinIO (S3-compatible) storage connector (parity: python/pathway/io/minio).

A thin shim over ``pw.io.s3``: MinIO speaks the S3 REST API, so the signed
client in ``io/_s3http.py`` covers it — only the endpoint settings differ
(path-style addressing on a custom endpoint).
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import s3 as _s3
from pathway_tpu_torch.io._s3http import AwsS3Settings

__all__ = ["MinIOSettings", "read"]


class MinIOSettings:
    """Parity: pw.io.minio.MinIOSettings."""

    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: str = "us-east-1",
        **_kw: Any,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def as_s3(self) -> AwsS3Settings:
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            region=self.region,
            endpoint=self.endpoint,
            with_path_style=self.with_path_style,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    format: str = "csv",
    schema: Any = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    json_field_paths: dict | None = None,
    downloader_threads_count: int | None = None,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    debug_data: Any = None,
    name: str | None = None,
    **kwargs: Any,
) -> Table:
    return _s3.read(
        path,
        aws_s3_settings=minio_settings.as_s3(),
        format=format,
        schema=schema,
        mode=mode,
        csv_settings=csv_settings,
        json_field_paths=json_field_paths,
        downloader_threads_count=downloader_threads_count,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        debug_data=debug_data,
        name=name,
        **kwargs,
    )
