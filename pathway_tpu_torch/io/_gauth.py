"""Google service-account OAuth2 (JWT bearer flow) — no client libraries.

The reference's BigQuery/PubSub/GDrive connectors authenticate with a
service-account JSON key via google-auth; this build implements the same
documented flow directly: build an RS256-signed JWT assertion and exchange
it at the token endpoint for a bearer token.  RSA signing (PKCS#1 v1.5 /
SHA-256) runs on Python big-int modexp over the key parsed from the PEM —
slow-ish (~ms) but executed once per ~hour per connector.
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json as _json
import time
import urllib.parse
from typing import Any

# ---------------------------------------------------------------------------
# minimal DER parsing (PKCS#8 / PKCS#1 RSA private keys)
# ---------------------------------------------------------------------------


def _der_read(data: bytes, pos: int) -> tuple[int, bytes, int]:
    """(tag, content, next_pos)"""
    tag = data[pos]
    pos += 1
    length = data[pos]
    pos += 1
    if length & 0x80:
        nbytes = length & 0x7F
        length = int.from_bytes(data[pos : pos + nbytes], "big")
        pos += nbytes
    return tag, data[pos : pos + length], pos + length


def _der_ints(seq: bytes, count: int) -> list[int]:
    out, pos = [], 0
    while len(out) < count and pos < len(seq):
        tag, content, pos = _der_read(seq, pos)
        if tag == 0x02:  # INTEGER
            out.append(int.from_bytes(content, "big"))
        # non-INTEGER elements are skipped; the caller validates the count
    return out


def parse_rsa_private_key(pem: str) -> tuple[int, int, int]:
    """(n, e, d) from a PKCS#8 ('PRIVATE KEY') or PKCS#1 ('RSA PRIVATE KEY')
    PEM block."""
    body = "".join(
        line
        for line in pem.strip().splitlines()
        if line and not line.startswith("-----")
    )
    der = base64.b64decode(body)
    tag, seq, _ = _der_read(der, 0)
    if tag != 0x30:
        raise ValueError("malformed key: expected SEQUENCE")
    if "BEGIN RSA PRIVATE KEY" not in pem:
        # PKCS#8: SEQUENCE { version, algorithm, OCTET STRING { PKCS#1 } }
        pos = 0
        _tag, _version, pos = _der_read(seq, pos)
        _tag, _alg, pos = _der_read(seq, pos)
        tag, inner, pos = _der_read(seq, pos)
        if tag != 0x04:
            raise ValueError("malformed PKCS#8 key: expected OCTET STRING")
        tag, seq, _ = _der_read(inner, 0)
        if tag != 0x30:
            raise ValueError("malformed inner PKCS#1 key")
    # PKCS#1 RSAPrivateKey: version, n, e, d, p, q, ...
    ints = _der_ints(seq, 4)
    if len(ints) < 4:
        raise ValueError("malformed RSA key: fewer than 4 integers")
    _version, n, e, d = ints[:4]
    return n, e, d


# ---------------------------------------------------------------------------
# RS256 (RSASSA-PKCS1-v1_5 with SHA-256)
# ---------------------------------------------------------------------------

# DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1)
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


def rs256_sign(message: bytes, n: int, d: int) -> bytes:
    k = (n.bit_length() + 7) // 8
    digest_info = _SHA256_PREFIX + hashlib.sha256(message).digest()
    pad_len = k - len(digest_info) - 3
    if pad_len < 8:
        raise ValueError("RSA key too small for SHA-256 signature")
    em = b"\x00\x01" + b"\xff" * pad_len + b"\x00" + digest_info
    m = int.from_bytes(em, "big")
    sig = pow(m, d, n)
    return sig.to_bytes(k, "big")


def rs256_verify(message: bytes, signature: bytes, n: int, e: int) -> bool:
    k = (n.bit_length() + 7) // 8
    m = pow(int.from_bytes(signature, "big"), e, n)
    em = m.to_bytes(k, "big")
    digest_info = _SHA256_PREFIX + hashlib.sha256(message).digest()
    pad_len = k - len(digest_info) - 3
    return em == b"\x00\x01" + b"\xff" * pad_len + b"\x00" + digest_info


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class ServiceAccountCredentials:
    """Bearer tokens from a service-account JSON key (JWT bearer flow)."""

    def __init__(self, info: dict[str, Any], scopes: list[str]):
        self.email = info["client_email"]
        self.token_uri = info.get("token_uri", "https://oauth2.googleapis.com/token")
        self.scopes = scopes
        self._n, self._e, self._d = parse_rsa_private_key(info["private_key"])
        self._token: str | None = None
        self._expiry = 0.0

    @classmethod
    def from_file(cls, path: str, scopes: list[str]) -> "ServiceAccountCredentials":
        with open(path) as f:
            return cls(_json.load(f), scopes)

    def _assertion(self, now: float) -> str:
        header = _b64url(_json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
        claims = _b64url(
            _json.dumps(
                {
                    "iss": self.email,
                    "scope": " ".join(self.scopes),
                    "aud": self.token_uri,
                    "iat": int(now),
                    "exp": int(now) + 3600,
                }
            ).encode()
        )
        signing_input = f"{header}.{claims}".encode()
        sig = rs256_sign(signing_input, self._n, self._d)
        return f"{header}.{claims}.{_b64url(sig)}"

    def token(self) -> str:
        now = time.time()
        if self._token is not None and now < self._expiry - 60:
            return self._token
        body = urllib.parse.urlencode(
            {
                "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
                "assertion": self._assertion(now),
            }
        ).encode()
        parsed = urllib.parse.urlparse(self.token_uri)
        conn_cls = (
            http.client.HTTPSConnection
            if parsed.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(parsed.netloc, timeout=30)
        try:
            conn.request(
                "POST",
                parsed.path or "/",
                body=body,
                headers={"Content-Type": "application/x-www-form-urlencoded"},
            )
            resp = conn.getresponse()
            raw = resp.read()
            try:
                payload = _json.loads(raw or b"{}")
            except ValueError:
                payload = {"raw": raw[:300].decode(errors="replace")}
            if resp.status >= 300 or "access_token" not in payload:
                raise RuntimeError(
                    f"token exchange failed ({resp.status}): "
                    f"{str(payload)[:300]}"
                )
        finally:
            conn.close()
        self._token = payload["access_token"]
        self._expiry = now + float(payload.get("expires_in", 3600))
        return self._token


# per-thread connection cache: polling readers issue one request per loop
# turn, and a fresh TLS handshake per call would dominate latency and churn
# sockets.  Thread-local because http.client connections are not thread-safe.
_conn_local = __import__("threading").local()


def _get_conn(scheme: str, netloc: str):
    cache = getattr(_conn_local, "conns", None)
    if cache is None:
        cache = _conn_local.conns = {}
    conn = cache.get((scheme, netloc))
    if conn is None:
        conn_cls = (
            http.client.HTTPSConnection
            if scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(netloc, timeout=60)
        cache[(scheme, netloc)] = conn
    return conn


def _drop_conn(scheme: str, netloc: str) -> None:
    cache = getattr(_conn_local, "conns", {})
    conn = cache.pop((scheme, netloc), None)
    if conn is not None:
        conn.close()


def api_request(
    creds: ServiceAccountCredentials,
    method: str,
    url: str,
    body: bytes | None = None,
    content_type: str = "application/json",
) -> tuple[int, bytes]:
    parsed = urllib.parse.urlparse(url)
    path = parsed.path + ("?" + parsed.query if parsed.query else "")
    headers = {"Authorization": f"Bearer {creds.token()}"}
    if body is not None:
        headers["Content-Type"] = content_type
    for attempt in (1, 2):  # one transparent retry on a dead pooled socket
        conn = _get_conn(parsed.scheme, parsed.netloc)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        except (http.client.HTTPException, ConnectionError, OSError):
            _drop_conn(parsed.scheme, parsed.netloc)
            if attempt == 2:
                raise
    raise AssertionError("unreachable")


_RETRYABLE = {429, 500, 502, 503, 504}


def api_request_retry(
    creds: ServiceAccountCredentials,
    method: str,
    url: str,
    body: bytes | None = None,
    *,
    attempts: int = 5,
) -> tuple[int, bytes]:
    """api_request with exponential backoff on throttle/server errors —
    streaming readers must survive the transient 429/5xx the Google APIs
    document as routine, not die and report clean source exhaustion."""
    delay = 0.5
    for attempt in range(attempts):
        status, payload = api_request(creds, method, url, body)
        if status not in _RETRYABLE or attempt == attempts - 1:
            return status, payload
        time.sleep(delay)
        delay = min(delay * 2, 15.0)
    return status, payload
