"""Google Drive source connector (parity: python/pathway/io/gdrive).

Reads objects under a Drive folder through the documented Drive v3 REST
API with service-account JWT auth (``io/_gauth.py``) — no googleapiclient.
Static mode reads the current snapshot; streaming mode polls
``modifiedTime`` so updated files re-read (replacing their previous row —
path-keyed upsert, like the reference's object-tracking refresh loop).
"""

from __future__ import annotations

import json as _json
import time as _time
import urllib.parse
from typing import Any

from pathway_tpu_torch.engine.types import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import _utils
from pathway_tpu_torch.io._gauth import ServiceAccountCredentials, api_request_retry
from pathway_tpu_torch.io._utils import COMMIT, DELETE, Offset, Reader

__all__ = [
    "read",
    "extend_metadata",
    "add_path",
    "add_seen_at",
    "add_status",
    "add_url",
]

_SCOPE = "https://www.googleapis.com/auth/drive.readonly"
_DEFAULT_API = "https://www.googleapis.com"


class _GDriveReader(Reader):
    supports_offsets = True

    def __init__(
        self,
        creds,
        object_id: str,
        mode: str,
        refresh_interval: float,
        api_base: str,
        with_metadata: bool,
        file_name_pattern: "str | list[str] | None" = None,
        object_size_limit: int | None = None,
    ):
        self.creds = creds
        self.object_id = object_id
        self.mode = mode
        self.refresh_interval = refresh_interval
        self.api_base = api_base
        self.with_metadata = with_metadata
        # glob pattern(s) on the file NAME; None keeps everything
        self.file_name_pattern = (
            [file_name_pattern]
            if isinstance(file_name_pattern, str)
            else file_name_pattern
        )
        self.object_size_limit = object_size_limit
        self._seen: dict[str, str] = {}  # file id -> modifiedTime

    def seek(self, offset: Any) -> None:
        self._seen = dict(offset.get("seen", {}))

    def _offset(self) -> Offset:
        return Offset({"seen": dict(self._seen)})

    _FOLDER_MIME = "application/vnd.google-apps.folder"
    # google-native types export to open formats; anything else
    # vnd.google-apps.* has no binary representation and is skipped
    _EXPORTS = {
        "application/vnd.google-apps.document": "text/plain",
        "application/vnd.google-apps.spreadsheet": "text/csv",
        "application/vnd.google-apps.presentation": "text/plain",
    }

    def _list_children(self, folder_id: str) -> list[dict]:
        files, token = [], None
        while True:
            params = {
                "q": f"'{folder_id}' in parents and trashed = false",
                "fields": "nextPageToken, files(id, name, mimeType, modifiedTime, size)",
                "pageSize": "1000",
            }
            if token:
                params["pageToken"] = token
            url = f"{self.api_base}/drive/v3/files?{urllib.parse.urlencode(params)}"
            status, payload = api_request_retry(self.creds, "GET", url)
            if status >= 300:
                raise RuntimeError(f"gdrive list failed ({status}): {payload[:300]!r}")
            parsed = _json.loads(payload or b"{}")
            files.extend(parsed.get("files", []))
            token = parsed.get("nextPageToken")
            if not token:
                return files

    def _list(self) -> list[dict]:
        """Recursive listing of downloadable files under the root folder."""
        out: list[dict] = []
        stack = [self.object_id]
        seen_folders = set()
        while stack:
            folder = stack.pop()
            if folder in seen_folders:
                continue
            seen_folders.add(folder)
            for f in self._list_children(folder):
                mime = f.get("mimeType", "")
                if mime == self._FOLDER_MIME:
                    stack.append(f["id"])
                elif mime.startswith("application/vnd.google-apps"):
                    if mime in self._EXPORTS:
                        out.append(f)
                    # other native types (forms, maps, …) have no export
                else:
                    out.append(f)
        return [f for f in out if self._accepts(f)]

    def _accepts(self, f: dict) -> bool:
        import fnmatch

        if self.file_name_pattern is not None and not any(
            fnmatch.fnmatch(f.get("name", ""), p) for p in self.file_name_pattern
        ):
            return False
        if self.object_size_limit is not None:
            try:
                if int(f.get("size", 0)) > self.object_size_limit:
                    return False
            except (TypeError, ValueError):
                pass
        return True

    def _download(self, f: dict) -> bytes:
        mime = f.get("mimeType", "")
        if mime in self._EXPORTS:
            # google-native files cannot alt=media; export to an open format
            export = urllib.parse.quote(self._EXPORTS[mime], safe="")
            url = (
                f"{self.api_base}/drive/v3/files/{f['id']}/export"
                f"?mimeType={export}"
            )
        else:
            url = f"{self.api_base}/drive/v3/files/{f['id']}?alt=media"
        status, payload = api_request_retry(self.creds, "GET", url)
        if status >= 300:
            raise RuntimeError(f"gdrive download failed ({status})")
        return payload

    def run(self, emit) -> None:
        while True:
            listing = self._list()
            current_ids = set()
            changed = False
            for f in sorted(listing, key=lambda f: f["id"]):
                fid, stamp = f["id"], f.get("modifiedTime", "")
                current_ids.add(fid)
                if self._seen.get(fid) == stamp:
                    continue
                row = {"data": self._download(f), "_pw_key": fid}
                if self.with_metadata:
                    row["_metadata"] = Json(
                        {
                            "id": fid,
                            "name": f.get("name"),
                            "mimeType": f.get("mimeType"),
                            "modifiedTime": stamp,
                        }
                    )
                emit(row)
                self._seen[fid] = stamp
                changed = True
            for gone in [i for i in self._seen if i not in current_ids]:
                emit({"_pw_key": gone, DELETE: True, "data": b""})
                del self._seen[gone]
                changed = True
            if changed:
                emit(self._offset())
                emit(COMMIT)
            if self.mode == "static":
                return
            _time.sleep(self.refresh_interval)


def read(
    object_id: str,
    *,
    service_user_credentials_file: str,
    mode: str = "streaming",
    refresh_interval: float = 30.0,
    with_metadata: bool = False,
    file_name_pattern: "str | list[str] | None" = None,
    object_size_limit: int | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    _api_base: str = _DEFAULT_API,
    **kwargs: Any,
) -> Table:
    """Read every file under a Drive folder id as binary rows.

    Reference: ``pw.io.gdrive.read`` (python/pathway/io/gdrive).
    """
    creds = ServiceAccountCredentials.from_file(
        service_user_credentials_file, [_SCOPE]
    )
    cols = {"data": schema_mod.ColumnSchema(name="data", dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = schema_mod.ColumnSchema(name="_metadata", dtype=dt.JSON)
    schema = schema_mod.schema_from_columns(cols)
    return _utils.make_input_table(
        schema,
        lambda: _GDriveReader(
            creds, object_id, mode, refresh_interval, _api_base, with_metadata,
            file_name_pattern=file_name_pattern,
            object_size_limit=object_size_limit,
        ),
        autocommit_duration_ms=autocommit_duration_ms,
        upsert=True,  # modified files replace their previous row
        name=name,
    )


# -- metadata post-processors (reference io/gdrive/__init__.py:44-70) --------

STATUS_DOWNLOADED = "downloaded"


def extend_metadata(metadata: dict) -> dict:
    """url + path + seen_at + status, composed."""
    return add_status(add_seen_at(add_path(add_url(metadata))))


def add_seen_at(metadata: dict) -> dict:
    metadata["seen_at"] = int(_time.time())
    return metadata


def add_url(metadata: dict) -> dict:
    file_id = metadata["id"]
    metadata["url"] = f"https://drive.google.com/file/d/{file_id}/"
    return metadata


def add_path(metadata: dict) -> dict:
    metadata["path"] = metadata["name"]
    return metadata


def add_status(metadata: dict) -> dict:
    metadata["status"] = STATUS_DOWNLOADED
    return metadata
