"""Microsoft SharePoint reader (enterprise-gated).

Parity target: ``python/pathway/xpacks/connectors/sharepoint/__init__.py``
— certificate-authenticated site access via the ``office365`` client,
polling a directory tree on ``refresh_interval``, emitting one binary
``data`` row per file (plus ``_metadata`` when requested) with
upsert/delete semantics on modification, gated on the
``XPACK-SHAREPOINT`` license entitlement.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.config import get_config
from pathway_tpu_torch.internals.license import License
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import python as io_python

logger = logging.getLogger("pathway_tpu_torch.xpacks.sharepoint")

STATUS_DOWNLOADED = "downloaded"
STATUS_SIZE_LIMIT_EXCEEDED = "size_limit_exceeded"


def _check_entitled() -> None:
    License.new(get_config().license_key).check_entitlements(["xpack-sharepoint"])


class _SharePointSubject(io_python.ConnectorSubject):
    """Polls the site tree and streams file snapshots as upserts."""

    def __init__(
        self,
        *,
        url: str,
        tenant: str,
        client_id: str,
        cert_path: str,
        thumbprint: str,
        root_path: str,
        mode: str,
        recursive: bool,
        object_size_limit: int | None,
        with_metadata: bool,
        refresh_interval: int,
        max_failed_attempts_in_row: int | None,
    ):
        super().__init__(datasource_name="sharepoint")
        self.url = url
        self.auth = dict(
            tenant=tenant,
            client_id=client_id,
            cert_path=cert_path,
            thumbprint=thumbprint,
        )
        self.root_path = root_path
        self.mode = mode
        self.recursive = recursive
        self.object_size_limit = object_size_limit
        self.with_metadata = with_metadata
        self.refresh_interval = refresh_interval
        self.max_failed_attempts_in_row = max_failed_attempts_in_row
        self._seen: dict[str, int] = {}  # path -> modified_at

    def _context(self):
        from office365.sharepoint.client_context import ClientContext

        return ClientContext(self.url).with_client_certificate(
            tenant=self.auth["tenant"],
            client_id=self.auth["client_id"],
            cert_path=self.auth["cert_path"],
            thumbprint=self.auth["thumbprint"],
        )

    def _walk(self, ctx, path: str):
        folder = ctx.web.get_folder_by_server_relative_path(path)
        ctx.load(folder.files).execute_query()
        for entry in folder.files:
            yield entry
        if self.recursive:
            ctx.load(folder.folders).execute_query()
            for sub in folder.folders:
                yield from self._walk(ctx, sub.properties["ServerRelativeUrl"])

    def _scan_once(self, ctx) -> None:
        for entry in self._walk(ctx, self.root_path):
            path = entry.properties["ServerRelativeUrl"]
            modified = int(entry.time_last_modified.timestamp())
            if self._seen.get(path) == modified:
                continue
            size = entry.length
            status = STATUS_DOWNLOADED
            if self.object_size_limit is not None and size > self.object_size_limit:
                status = STATUS_SIZE_LIMIT_EXCEEDED
                payload = b""
            else:
                payload = entry.read()
            self._seen[path] = modified
            row: dict[str, Any] = {"data": payload, "_pw_key": path}
            if self.with_metadata:
                row["_metadata"] = json.dumps(
                    {
                        "path": path,
                        "size": size,
                        "modified_at": modified,
                        "created_at": int(entry.time_created.timestamp()),
                        "seen_at": int(time.time()),
                        "status": status,
                    }
                )
            self.next(**row)

    def run(self) -> None:
        failures = 0
        while True:
            try:
                self._scan_once(self._context())
                failures = 0
            except Exception as exc:
                failures += 1
                logger.warning("sharepoint scan failed (%d in row): %s", failures, exc)
                if (
                    self.max_failed_attempts_in_row is not None
                    and failures >= self.max_failed_attempts_in_row
                ):
                    raise
            self.commit()
            if self.mode == "static":
                break
            time.sleep(self.refresh_interval)
        self.close()


def read(
    url: str,
    *,
    tenant: str,
    client_id: str,
    cert_path: str,
    thumbprint: str,
    root_path: str,
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    max_failed_attempts_in_row: int | None = 8,
) -> Table:
    """Read a SharePoint directory/file as a binary ``data`` table.

    Requires the XPACK-SHAREPOINT license entitlement and the optional
    ``office365`` client package (reference gates identically via
    ``optional_imports("xpack-sharepoint")``).
    """
    _check_entitled()
    try:
        import office365  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "pw.xpacks.connectors.sharepoint.read requires the 'office365' "
            "package, which is not installed in this environment"
        ) from exc
    cols = {"data": schema_mod.ColumnSchema(name="data", dtype=schema_mod.dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = schema_mod.ColumnSchema(
            name="_metadata", dtype=schema_mod.dt.JSON
        )
    schema = schema_mod.schema_from_columns(cols, name="SharePointSchema")
    subject = _SharePointSubject(
        url=url,
        tenant=tenant,
        client_id=client_id,
        cert_path=cert_path,
        thumbprint=thumbprint,
        root_path=root_path,
        mode=mode,
        recursive=recursive,
        object_size_limit=object_size_limit,
        with_metadata=with_metadata,
        refresh_interval=refresh_interval,
        max_failed_attempts_in_row=max_failed_attempts_in_row,
    )
    return io_python.read(subject, schema=schema)
