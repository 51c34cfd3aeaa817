"""Amazon S3 / S3-compatible object storage reader (parity:
python/pathway/io/s3; engine scanner ``src/connectors/scanner/s3.rs`` via
``PosixLikeReader`` ``posix_like.rs:39``).

Implemented over the signed REST client in ``io/_s3http.py`` — no boto
required.  Static mode reads the current object snapshot; streaming mode
polls the prefix for new objects (the S3 scanner's modified-object loop).
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
import time as _time
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._s3http import AwsS3Settings, S3Client
from pathway_tpu_torch.io._utils import COMMIT, Offset, Reader

__all__ = [
    "AwsS3Settings",
    "DigitalOceanS3Settings",
    "WasabiS3Settings",
    "read",
    "read_from_digital_ocean",
    "read_from_wasabi",
]


class _S3Reader(Reader):
    supports_offsets = True

    def __init__(
        self,
        client: S3Client,
        prefix: str,
        format: str,
        schema: type[schema_mod.Schema] | None,
        mode: str,
        csv_settings: dict | None,
        poll_interval_s: float = 5.0,
        with_metadata: bool = False,
        json_field_paths: dict | None = None,
        downloader_threads_count: int | None = None,
    ):
        self.client = client
        self.prefix = prefix
        self.format = format
        self.schema = schema
        self.mode = mode
        self.csv_settings = csv_settings or {}
        self.poll_interval_s = poll_interval_s
        self.with_metadata = with_metadata
        self.json_field_paths = json_field_paths
        self.downloader_threads_count = downloader_threads_count
        # progress = high-water mark over (last_modified, key): O(1)-ish
        # offsets, and an object overwritten in place gets a newer
        # last_modified so it is re-read (the scanner's modified-object
        # loop).  _at_mark disambiguates several objects sharing the
        # watermark timestamp.
        self._watermark = ""
        self._at_mark: set[str] = set()
        self._stripe: tuple[int, int] | None = None

    # file-grained striping across workers, like the fs scanner
    def partition(self, worker_id: int, worker_count: int) -> "_S3Reader":
        self._stripe = (worker_id, worker_count)
        return self

    def _mine(self, key: str) -> bool:
        if self._stripe is None:
            return True
        wid, n = self._stripe
        from pathway_tpu_torch.engine.types import hash_values

        return hash_values([key]) % n == wid

    def seek(self, offset: Any) -> None:
        self._watermark = offset.get("watermark", "")
        self._at_mark = set(offset.get("at_mark", []))

    def _offset(self) -> Offset:
        return Offset(
            {"watermark": self._watermark, "at_mark": sorted(self._at_mark)}
        )

    @staticmethod
    def _stamp(obj: dict) -> str:
        return obj.get("last_modified") or obj.get("etag") or ""

    def _is_new(self, obj: dict) -> bool:
        stamp = self._stamp(obj)
        if stamp > self._watermark:
            return True
        if stamp == self._watermark and obj["key"] not in self._at_mark:
            return True
        return False

    def _advance(self, obj: dict) -> None:
        stamp = self._stamp(obj)
        if stamp > self._watermark:
            self._watermark = stamp
            self._at_mark = {obj["key"]}
        elif stamp == self._watermark:
            self._at_mark.add(obj["key"])

    def _rows_of(self, key: str, body: bytes):
        if self.format == "csv":
            from pathway_tpu_torch.io.csv import _convert

            text = body.decode("utf-8", errors="replace")
            reader = _csv.DictReader(_io.StringIO(text), **self.csv_settings)
            names = list(self.schema.__columns__.keys()) if self.schema else None
            dtypes = (
                {n: self.schema.__columns__[n].dtype for n in names}
                if names
                else {}
            )
            for rec in reader:
                if names is None:
                    yield dict(rec)
                else:
                    yield {n: _convert(rec.get(n), dtypes[n]) for n in names}
        elif self.format in ("json", "jsonlines"):
            names = list(self.schema.__columns__.keys()) if self.schema else None
            for line in body.splitlines():
                if not line.strip():
                    continue
                try:
                    obj = _json.loads(line)
                except _json.JSONDecodeError:
                    continue
                if names is None:
                    yield {k: Json(v) if isinstance(v, (dict, list)) else v for k, v in obj.items()}
                else:
                    paths = self.json_field_paths
                    if paths:
                        from pathway_tpu_torch.io.jsonlines import _extract_path

                        picked = (
                            (n, _extract_path(obj, paths[n]) if n in paths else obj.get(n))
                            for n in names
                        )
                    else:
                        picked = ((n, obj.get(n)) for n in names)
                    yield {
                        n: (Json(v) if isinstance(v, (dict, list)) else v)
                        for n, v in picked
                    }
        elif self.format == "plaintext":
            for line in body.decode("utf-8", errors="replace").splitlines():
                yield {"data": line}
        elif self.format in ("binary", "raw"):
            yield {"data": body}
        elif self.format == "plaintext_by_object":
            yield {"data": body.decode("utf-8", errors="replace")}
        else:
            raise ValueError(f"unknown s3 format {self.format!r}")

    def run(self, emit) -> None:
        while True:
            objects = self.client.list_objects(self.prefix)
            new = [
                o
                for o in sorted(objects, key=lambda o: (self._stamp(o), o["key"]))
                if self._is_new(o) and self._mine(o["key"])
            ]
            def _emit_object(obj, body):
                for row in self._rows_of(obj["key"], body):
                    if self.with_metadata:
                        row["_metadata"] = Json(
                            {"path": obj["key"], "size": obj["size"], "etag": obj["etag"]}
                        )
                    emit(row)
                self._advance(obj)
                emit(self._offset())
                emit(COMMIT)

            n_threads = self.downloader_threads_count or 1
            if n_threads > 1 and len(new) > 1:
                # parallel GETs, ordered emission; chunked so at most one
                # chunk of bodies is resident at a time
                from concurrent.futures import ThreadPoolExecutor

                chunk = 4 * n_threads
                with ThreadPoolExecutor(n_threads) as ex:
                    for i in range(0, len(new), chunk):
                        batch = new[i : i + chunk]
                        bodies = list(
                            ex.map(
                                lambda o: self.client.get_object(o["key"]),
                                batch,
                            )
                        )
                        for obj, body in zip(batch, bodies):
                            _emit_object(obj, body)
            else:
                for obj in new:
                    _emit_object(obj, self.client.get_object(obj["key"]))
            if self.mode == "static":
                return
            _time.sleep(self.poll_interval_s)


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "csv",
    schema: type[schema_mod.Schema] | None = None,
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
    """Read objects under ``path`` (``s3://bucket/prefix`` or plain prefix).

    Reference: ``pw.io.s3.read`` (python/pathway/io/s3).
    """
    settings = aws_s3_settings or AwsS3Settings()
    bucket, prefix = _split_path(path, settings)
    client = settings.client(bucket)
    if format in ("plaintext", "binary", "raw", "plaintext_by_object") and schema is None:
        value_type = bytes if format in ("binary", "raw") else str
        schema = schema_mod.schema_from_types(data=value_type)
    if schema is None:
        raise ValueError("s3.read requires schema= for csv/json formats")
    if with_metadata:
        cols = dict(schema.__columns__)
        from pathway_tpu_torch.internals import dtype as dt

        cols["_metadata"] = schema_mod.ColumnSchema(name="_metadata", dtype=dt.JSON)
        schema = schema_mod.schema_from_columns(cols)
    if hasattr(csv_settings, "as_dict"):
        csv_kw = csv_settings.as_dict()
    elif isinstance(csv_settings, dict):
        csv_kw = csv_settings
    else:
        csv_kw = {}
    return _utils.make_input_table(
        schema,
        lambda: _S3Reader(
            client,
            prefix,
            format,
            schema,
            mode,
            csv_kw,
            with_metadata=with_metadata,
            json_field_paths=json_field_paths,
            downloader_threads_count=downloader_threads_count,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        debug_data=debug_data,
    )


def _split_path(path: str, settings: AwsS3Settings) -> tuple[str | None, str]:
    if path.startswith("s3://"):
        rest = path[5:]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    return settings.bucket_name, path.lstrip("/")


class DigitalOceanS3Settings(AwsS3Settings):
    """Digital Ocean Spaces settings (parity: io/s3/__init__.py:23) —
    AwsS3Settings preconfigured with the DO endpoint convention."""

    def __init__(
        self,
        bucket_name: str,
        *,
        access_key: str = "",
        secret_access_key: str = "",
        region: str,
    ):
        if not region:
            raise ValueError(
                "DigitalOceanS3Settings requires region= — it routes the "
                "endpoint (e.g. 'ams3' -> ams3.digitaloceanspaces.com); "
                "without it reads would silently target AWS S3"
            )
        super().__init__(
            bucket_name=bucket_name,
            access_key=access_key,
            secret_access_key=secret_access_key,
            region=region,
            endpoint=f"https://{region}.digitaloceanspaces.com",
        )


class WasabiS3Settings(AwsS3Settings):
    """Wasabi S3 settings (parity: io/s3/__init__.py:58)."""

    def __init__(
        self,
        bucket_name: str,
        *,
        access_key: str = "",
        secret_access_key: str = "",
        region: str,
    ):
        if not region:
            raise ValueError(
                "WasabiS3Settings requires region= — it routes the endpoint "
                "(e.g. 'us-west-1' -> s3.us-west-1.wasabisys.com)"
            )
        super().__init__(
            bucket_name=bucket_name,
            access_key=access_key,
            secret_access_key=secret_access_key,
            region=region,
            endpoint=f"https://s3.{region}.wasabisys.com",
        )


def read_from_digital_ocean(
    path: str,
    do_s3_settings: DigitalOceanS3Settings,
    format: str = "csv",
    **kwargs: Any,
) -> Table:
    """``pw.io.s3.read`` preconfigured for Digital Ocean Spaces."""
    return read(path, aws_s3_settings=do_s3_settings, format=format, **kwargs)


def read_from_wasabi(
    path: str,
    wasabi_s3_settings: WasabiS3Settings,
    format: str = "csv",
    **kwargs: Any,
) -> Table:
    """``pw.io.s3.read`` preconfigured for Wasabi S3."""
    return read(path, aws_s3_settings=wasabi_s3_settings, format=format, **kwargs)
