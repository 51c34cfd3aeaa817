"""Minimal Google Cloud Storage JSON-API client (no SDK).

The natural object store for TPU deployments (SURVEY.md §7 step 9 names
fs/GCS persistence).  Issues the four requests the persistence backend
needs — upload, get, delete, and paged list — over ``http.client`` against
``storage.googleapis.com`` or an emulator endpoint (fake-gcs-server).

Auth: ``Authorization: Bearer <token>``.  The token comes from a
``token_provider`` callable; the default fetches from the GCE/TPU-VM
metadata server (the standard ambient identity on GCP hosts) and caches
until near expiry.  Emulators need no token.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.parse
from typing import Callable

METADATA_HOST = "metadata.google.internal"
METADATA_PATH = (
    "/computeMetadata/v1/instance/service-accounts/default/token"
)


class GcsError(RuntimeError):
    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status
        # only an *object*-level 404 means "blob absent"; auth/metadata
        # failures must never read as not-found (see GcsAuthError)
        self.is_not_found = status == 404


class GcsAuthError(GcsError):
    """Token acquisition failed — unrelated to object existence."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message, status)
        self.is_not_found = False


def metadata_token_provider(timeout: float = 5.0) -> Callable[[], str]:
    """Bearer tokens from the GCE metadata server, cached until expiry."""
    state = {"token": "", "expires": 0.0}

    def provide() -> str:
        now = time.monotonic()
        if state["token"] and now < state["expires"] - 60:
            return state["token"]
        conn = http.client.HTTPConnection(METADATA_HOST, timeout=timeout)
        try:
            conn.request(
                "GET", METADATA_PATH, headers={"Metadata-Flavor": "Google"}
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise GcsAuthError(
                    f"metadata token fetch: HTTP {resp.status}", resp.status
                )
        finally:
            conn.close()
        payload = json.loads(data)
        state["token"] = payload["access_token"]
        state["expires"] = now + float(payload.get("expires_in", 300))
        return state["token"]

    return provide


class GcsClient:
    def __init__(
        self,
        bucket: str,
        *,
        token_provider: Callable[[], str] | None = None,
        endpoint: str | None = None,
        timeout: float = 30.0,
    ):
        self.bucket = bucket
        self.timeout = timeout
        if endpoint:
            parsed = urllib.parse.urlparse(
                endpoint if "//" in endpoint else "https://" + endpoint
            )
            self.scheme = parsed.scheme or "https"
            self.host = parsed.netloc
            self.base = parsed.path.rstrip("/")
            # emulators typically run tokenless
            self.token_provider = token_provider
        else:
            self.scheme = "https"
            self.host = "storage.googleapis.com"
            self.base = ""
            self.token_provider = token_provider or metadata_token_provider()

    def _request(self, verb: str, path: str, body: bytes = b"", ok=(200, 204)):
        headers = {"Content-Length": str(len(body))}
        if self.token_provider is not None:
            headers["Authorization"] = f"Bearer {self.token_provider()}"
        conn_cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(self.host, timeout=self.timeout)
        try:
            conn.request(verb, self.base + path, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status not in ok:
                raise GcsError(
                    f"{verb} {path}: HTTP {resp.status} {data[:200]!r}",
                    status=resp.status,
                )
            return data
        finally:
            conn.close()

    def _opath(self, name: str) -> str:
        return urllib.parse.quote(name, safe="")

    def put_object(self, name: str, data: bytes) -> None:
        self._request(
            "POST",
            f"/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={self._opath(name)}",
            body=data,
        )

    def get_object(self, name: str) -> bytes:
        return self._request(
            "GET", f"/storage/v1/b/{self.bucket}/o/{self._opath(name)}?alt=media"
        )

    def delete_object(self, name: str) -> None:
        self._request(
            "DELETE", f"/storage/v1/b/{self.bucket}/o/{self._opath(name)}"
        )

    def list_objects(self, prefix: str = "") -> list[str]:
        names: list[str] = []
        page = ""
        while True:
            q = f"?prefix={urllib.parse.quote(prefix, safe='')}"
            if page:
                q += f"&pageToken={urllib.parse.quote(page)}"
            data = self._request("GET", f"/storage/v1/b/{self.bucket}/o{q}")
            payload = json.loads(data or b"{}")
            names.extend(item["name"] for item in payload.get("items", []))
            page = payload.get("nextPageToken", "")
            if not page:
                return names
