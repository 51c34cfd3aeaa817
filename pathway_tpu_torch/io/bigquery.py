"""Google BigQuery sink connector (parity: python/pathway/io/bigquery).

Writes through the documented ``tabledata.insertAll`` REST endpoint with
service-account JWT auth (``io/_gauth.py``) — no google-cloud client.
Each engine epoch flushes one insertAll batch; rows carry ``time``/``diff``
columns like the reference's streaming-insert sink.
"""

from __future__ import annotations

import json as _json
import threading
from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._gauth import ServiceAccountCredentials, api_request

__all__ = ["write"]

_SCOPE = "https://www.googleapis.com/auth/bigquery.insertdata"
_DEFAULT_API = "https://bigquery.googleapis.com"


class _BigQuerySink:
    def __init__(
        self,
        dataset: str,
        table_name: str,
        creds: ServiceAccountCredentials,
        project: str,
        api_base: str,
    ):
        self.url = (
            f"{api_base}/bigquery/v2/projects/{project}/datasets/{dataset}"
            f"/tables/{table_name}/insertAll"
        )
        self.creds = creds
        self._rows: list[dict] = []
        self._lock = threading.Lock()

    def add(self, row: dict) -> None:
        with self._lock:
            self._rows.append(row)

    def flush(self, _time: int | None = None) -> None:
        with self._lock:
            if not self._rows:
                return
            body = _json.dumps(
                {"rows": [{"json": r} for r in self._rows]}
            ).encode()
            status, payload = api_request(self.creds, "POST", self.url, body)
            try:
                parsed = _json.loads(payload or b"{}")
            except ValueError:
                parsed = {"raw": payload[:300].decode(errors="replace")}
            if status >= 300 or parsed.get("insertErrors"):
                raise RuntimeError(
                    f"bigquery insertAll failed ({status}): "
                    f"{str(parsed)[:500]}"
                )
            self._rows = []


def write(
    table: Table,
    dataset_name: str,
    table_name: str,
    service_user_credentials_file: str,
    *,
    name: str | None = None,
    _api_base: str = _DEFAULT_API,
    _sink_factory: Any = None,
) -> None:
    """Stream the change stream into a BigQuery table.

    Reference: ``pw.io.bigquery.write`` (python/pathway/io/bigquery).
    """
    names = table.column_names()
    with open(service_user_credentials_file) as f:
        info = _json.load(f)
    creds = ServiceAccountCredentials(info, [_SCOPE])
    sink = (_sink_factory or _BigQuerySink)(
        dataset_name, table_name, creds, info["project_id"], _api_base
    )

    def on_data(key, row, time, diff):
        obj = {n: _utils.plain_value(v, bytes_as="base64") for n, v in zip(names, row)}
        obj["time"], obj["diff"] = time, diff
        sink.add(obj)

    _utils.register_output(
        table,
        on_data,
        on_time_end=sink.flush,
        on_end=sink.flush,
        name=name or f"bigquery:{dataset_name}.{table_name}",
    )
