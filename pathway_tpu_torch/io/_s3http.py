"""Minimal S3 REST client with AWS Signature Version 4 (no boto).

The reference links the AWS SDK for its S3 scanner
(upstream Pathway's ``src/connectors/scanner/s3.rs``); this build signs and
issues the two requests a streaming object reader needs — ListObjectsV2 and
GetObject — directly over ``http.client``.  Works against AWS S3 and any
S3-compatible endpoint (MinIO, GCS interop, localstack).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Any


class S3Error(RuntimeError):
    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    def __init__(
        self,
        bucket: str,
        *,
        access_key: str = "",
        secret_access_key: str = "",
        region: str = "us-east-1",
        endpoint: str | None = None,
        with_path_style: bool = True,
        timeout: float = 30.0,
    ):
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_access_key
        self.region = region
        self.timeout = timeout
        if endpoint:
            parsed = urllib.parse.urlparse(
                endpoint if "//" in endpoint else "https://" + endpoint
            )
            self.secure = parsed.scheme != "http"
            self.host = parsed.netloc
            self.path_style = with_path_style
        else:
            self.secure = True
            self.path_style = with_path_style
            if with_path_style:
                self.host = f"s3.{region}.amazonaws.com"
            else:
                # virtual-host addressing: bucket in the host name
                self.host = f"{bucket}.s3.{region}.amazonaws.com"

    # -- signing (SigV4) --

    def _request(
        self, path: str, query: dict[str, str], method: str = "GET", body: bytes = b""
    ) -> bytes:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(body).hexdigest()

        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(str(v), safe='-_.~')}"
            for k, v in sorted(query.items())
        )
        headers = {
            "host": self.host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join(
            [
                method,
                urllib.parse.quote(path),
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        k = _sign(("AWS4" + self.secret_key).encode(), datestamp)
        k = _sign(k, self.region)
        k = _sign(k, "s3")
        k = _sign(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        auth = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )

        conn_cls = http.client.HTTPSConnection if self.secure else http.client.HTTPConnection
        conn = conn_cls(self.host, timeout=self.timeout)
        try:
            # request the exact path that was signed — an unencoded space or
            # special character would both break the request line and fail
            # the server-side signature check
            url = urllib.parse.quote(path) + (
                "?" + canonical_query if canonical_query else ""
            )
            req_headers = {
                "Host": self.host,
                "x-amz-content-sha256": payload_hash,
                "x-amz-date": amz_date,
            }
            if self.access_key:
                req_headers["Authorization"] = auth
            conn.request(method, url, body=body or None, headers=req_headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status >= 300:
                raise S3Error(
                    f"S3 {resp.status} for {url}: {body[:500].decode(errors='replace')}",
                    status=resp.status,
                )
            return body
        finally:
            conn.close()

    def _base_path(self) -> str:
        return f"/{self.bucket}" if self.path_style else ""

    # -- operations --

    def list_objects(self, prefix: str = "") -> list[dict[str, Any]]:
        """All objects under prefix: [{key, size, etag, last_modified}]."""
        out: list[dict[str, Any]] = []
        token: str | None = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            body = self._request(self._base_path() or "/", query)
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag.split("}")[0] + "}"
            for item in root.iter(f"{ns}Contents"):
                out.append(
                    {
                        "key": item.findtext(f"{ns}Key"),
                        "size": int(item.findtext(f"{ns}Size") or 0),
                        "etag": (item.findtext(f"{ns}ETag") or "").strip('"'),
                        "last_modified": item.findtext(f"{ns}LastModified"),
                    }
                )
            truncated = (root.findtext(f"{ns}IsTruncated") or "false") == "true"
            token = root.findtext(f"{ns}NextContinuationToken")
            if not truncated or not token:
                return out

    def get_object(self, key: str) -> bytes:
        return self._request(f"{self._base_path()}/{key}", {})

    def put_object(self, key: str, data: bytes) -> None:
        self._request(f"{self._base_path()}/{key}", {}, method="PUT", body=data)

    def delete_object(self, key: str) -> None:
        self._request(f"{self._base_path()}/{key}", {}, method="DELETE")


class AwsS3Settings:
    """Connection settings (parity: pw.io.s3.AwsS3Settings)."""

    def __init__(
        self,
        *,
        bucket_name: str | None = None,
        access_key: str = "",
        secret_access_key: str = "",
        region: str = "us-east-1",
        endpoint: str | None = None,
        with_path_style: bool = False,
        **_kw: Any,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style

    def client(self, bucket: str | None = None) -> S3Client:
        b = bucket or self.bucket_name
        if not b:
            raise ValueError("bucket_name is required")
        return S3Client(
            b,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            region=self.region,
            endpoint=self.endpoint,
            with_path_style=self.with_path_style or bool(self.endpoint),
        )
