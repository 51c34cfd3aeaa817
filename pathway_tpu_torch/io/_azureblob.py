"""Minimal Azure Blob Storage REST client with SharedKey auth (no SDK).

The reference's persistence layer gains Azure support through the object
-store SDKs; this build signs and issues the four requests the persistence
backend needs — Put Blob, Get Blob, Delete Blob, and List Blobs — directly
over ``http.client``.  Works against real Azure Storage and any
API-compatible endpoint (Azurite emulator) via ``endpoint=``.

Auth: SharedKey — ``Authorization: SharedKey <account>:<signature>`` where
the signature is HMAC-SHA256 over the canonicalized request string
(https://learn.microsoft.com/rest/api/storageservices/authorize-with-shared-key).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET

API_VERSION = "2021-08-06"


class AzureBlobError(RuntimeError):
    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class AzureBlobClient:
    def __init__(
        self,
        account: str,
        container: str,
        *,
        account_key: str = "",
        endpoint: str | None = None,
        timeout: float = 30.0,
    ):
        self.account = account
        self.container = container
        self.key = base64.b64decode(account_key) if account_key else b""
        self.timeout = timeout
        if endpoint:
            parsed = urllib.parse.urlparse(
                endpoint if "//" in endpoint else "https://" + endpoint
            )
            self.scheme = parsed.scheme or "https"
            self.host = parsed.netloc
            # emulators (Azurite) route as /<account>/<container>
            self.base_path = f"{parsed.path.rstrip('/')}/{account}"
        else:
            self.scheme = "https"
            self.host = f"{account}.blob.core.windows.net"
            self.base_path = ""

    # -- signing ---------------------------------------------------------

    def _auth_header(
        self, verb: str, path: str, query: dict, headers: dict
    ) -> str:
        # canonicalized x-ms-* headers, sorted, lowercase
        xms = sorted(
            (k.lower(), v) for k, v in headers.items() if k.lower().startswith("x-ms-")
        )
        canon_headers = "".join(f"{k}:{v}\n" for k, v in xms)
        # canonicalized resource: /account/path then sorted query params
        canon_res = f"/{self.account}{path}"
        for k in sorted(query):
            canon_res += f"\n{k.lower()}:{query[k]}"
        length = headers.get("Content-Length", "")
        if length == "0":
            length = ""  # 2015-02-21+ semantics: empty for zero-length
        to_sign = "\n".join(
            [
                verb,
                "",  # Content-Encoding
                "",  # Content-Language
                length,
                "",  # Content-MD5
                headers.get("Content-Type", ""),
                "",  # Date (x-ms-date used instead)
                "",  # If-Modified-Since
                "",  # If-Match
                "",  # If-None-Match
                "",  # If-Unmodified-Since
                "",  # Range
                canon_headers + canon_res,
            ]
        )
        sig = base64.b64encode(
            hmac.new(self.key, to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"

    # -- transport -------------------------------------------------------

    def _request(
        self,
        verb: str,
        blob: str | None,
        query: dict | None = None,
        body: bytes = b"",
        extra_headers: dict | None = None,
        ok: tuple = (200, 201, 202),
    ):
        query = dict(query or {})
        path = f"{self.base_path}/{self.container}"
        if blob is not None:
            path += "/" + urllib.parse.quote(blob)
        import email.utils

        # locale-independent RFC-1123 date (strftime %a/%b break SharedKey
        # signing under non-English LC_TIME)
        now = email.utils.formatdate(usegmt=True)
        headers = {
            "x-ms-date": now,
            "x-ms-version": API_VERSION,
            "Content-Length": str(len(body)),
        }
        if verb == "PUT" and blob is not None and "comp" not in query:
            headers["x-ms-blob-type"] = "BlockBlob"
        headers.update(extra_headers or {})
        if self.key:
            headers["Authorization"] = self._auth_header(verb, path, query, headers)
        qs = urllib.parse.urlencode(query)
        url_path = path + ("?" + qs if qs else "")
        conn_cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(self.host, timeout=self.timeout)
        try:
            conn.request(verb, url_path, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status not in ok:
                raise AzureBlobError(
                    f"{verb} {url_path}: HTTP {resp.status} {data[:200]!r}",
                    status=resp.status,
                )
            return resp.status, data
        finally:
            conn.close()

    # -- blob operations -------------------------------------------------

    def put_blob(self, name: str, data: bytes) -> None:
        self._request("PUT", name, body=data)

    def get_blob(self, name: str) -> bytes:
        _, data = self._request("GET", name)
        return data

    def delete_blob(self, name: str) -> None:
        self._request("DELETE", name, ok=(200, 202))

    def list_blobs(self, prefix: str = "") -> list[str]:
        names: list[str] = []
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list", "prefix": prefix}
            if marker:
                query["marker"] = marker
            _, data = self._request("GET", None, query=query)
            root = ET.fromstring(data)
            for b in root.iter("Blob"):
                n = b.find("Name")
                if n is not None and n.text:
                    names.append(n.text)
            nm = root.find("NextMarker")
            marker = (nm.text or "") if nm is not None else ""
            if not marker:
                return names
