"""License keys and entitlement gates.

Parity target: ``src/engine/license.rs`` — three license shapes:

* no key → no entitlements (free tier; everything core still works),
* an offline license file (``-----BEGIN LICENSE FILE-----``), an
  ed25519-signed JSON payload carrying entitlements / policy /
  ``telemetry_required`` (``license.rs:25`` ``base64+ed25519``),
* a plain license key, validated against a license server in the
  reference (``license.rs:22``) — this build has no egress, so plain
  keys resolve against the built-in demo-key registry instead and
  anything unknown fails entitlement checks with the same error type.

Entitlement names are case-insensitive (uppercased, ``license.rs:60``).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field

LICENSE_ALGORITHM = "base64+ed25519"
_FILE_HEADER = "-----BEGIN LICENSE FILE-----"
_FILE_FOOTER = "-----END LICENSE FILE-----"

# verifying key for offline license files (hex, 32 bytes).  Generated for
# this framework; see tests for the signing half used in fixtures.
PUBLIC_KEY = "de259851694be86bf8d9d9c11104f0a9a5c74fbdc96ef4613ed375fd44e7c338"

# demo keys (the reference's publicly distributed monitoring keys resolve
# server-side; with zero egress the registry is local)
_DEMO_KEY_PREFIX = "demo-license-key-with-telemetry"
_DEMO_ENTITLEMENTS = frozenset({"XPACK-SPATIAL", "MONITORING", "TELEMETRY"})


class LicenseError(Exception):
    pass


class InsufficientLicenseError(LicenseError):
    def __init__(self, entitlements: list[str]):
        super().__init__(
            "one of the features you used requires upgrading your Pathway "
            f"license (missing entitlements: {', '.join(entitlements)})"
        )
        self.entitlements = entitlements


@dataclass(frozen=True)
class License:
    key: str = ""
    entitlements: frozenset[str] = frozenset()
    telemetry_required: bool = False
    policy: str = ""
    offline: bool = False

    @classmethod
    def new(cls, license_key: str | None) -> "License":
        key = (license_key or "").strip()
        if not key:
            return cls()
        if key.startswith(_FILE_HEADER):
            return _parse_offline_license(key)
        if key.startswith(_DEMO_KEY_PREFIX):
            return cls(
                key=key, entitlements=_DEMO_ENTITLEMENTS, telemetry_required=True
            )
        # unknown plain key: kept (its shortcut is reported in telemetry)
        # but grants nothing without the license server
        return cls(key=key)

    def check_entitlements(self, entitlements: list[str] | str) -> None:
        if isinstance(entitlements, str):
            entitlements = [entitlements]
        wanted = [e.upper() for e in entitlements]
        if not all(e in self.entitlements for e in wanted):
            raise InsufficientLicenseError(wanted)

    def has_entitlement(self, entitlement: str) -> bool:
        return entitlement.upper() in self.entitlements

    def shortcut(self) -> str:
        """First two dash-separated groups of a well-formed key (license.rs:92)."""
        parts = self.key.split("-")
        if len(parts) >= 5 and all(parts[:5]):
            return f"{parts[0]}-{parts[1]}"
        return ""


def _parse_offline_license(text: str) -> License:
    """Verify and decode an offline license file.

    Format (keygen-style, matching the reference's dependency): the body is
    base64 of ``{"enc": <base64 payload>, "sig": <base64 ed25519 signature
    over b"license/" + enc>, "alg": "base64+ed25519"}``; the payload JSON
    carries ``entitlements`` (list), ``policy``, ``telemetry_required``.
    """
    body = text.strip()
    if body.startswith(_FILE_HEADER):
        body = body[len(_FILE_HEADER):]
    if body.endswith(_FILE_FOOTER):
        body = body[: -len(_FILE_FOOTER)]
    try:
        outer = json.loads(base64.b64decode("".join(body.split())))
        enc, sig, alg = outer["enc"], outer["sig"], outer.get("alg", "")
    except Exception as exc:
        raise LicenseError(f"malformed license file: {exc}") from exc
    if alg != LICENSE_ALGORITHM:
        raise LicenseError(f"unsupported license algorithm {alg!r}")
    try:
        # optional dependency, guarded like trace.py's add_note shim: the
        # cryptography wheel is preferred when present, but its absence
        # degrades to the pure-Python RFC 8032 verifier — never to an
        # ImportError that takes unrelated license paths down with it
        try:
            from cryptography.hazmat.primitives.asymmetric.ed25519 import (
                Ed25519PublicKey,
            )
        except ImportError:
            from pathway_tpu_torch.internals import _ed25519

            if not _ed25519.verify(
                bytes.fromhex(PUBLIC_KEY),
                base64.b64decode(sig),
                b"license/" + enc.encode(),
            ):
                raise LicenseError("license signature verification failed")
        else:
            verifier = Ed25519PublicKey.from_public_bytes(
                bytes.fromhex(PUBLIC_KEY)
            )
            verifier.verify(base64.b64decode(sig), b"license/" + enc.encode())
    except LicenseError:
        raise
    except Exception as exc:
        raise LicenseError(f"license signature verification failed: {exc}") from exc
    try:
        payload = json.loads(base64.b64decode(enc))
    except Exception as exc:
        raise LicenseError(f"malformed license payload: {exc}") from exc
    return License(
        key="",
        entitlements=frozenset(e.upper() for e in payload.get("entitlements", [])),
        telemetry_required=bool(payload.get("telemetry_required", False)),
        policy=str(payload.get("policy", "")),
        offline=True,
    )
