"""Minimal BSON encoder/decoder (no pymongo).

The reference's MongoWriter formats rows as BSON via the mongodb crate
(``src/connectors/data_storage.rs:1697``,
``data_format.rs:2068`` BsonFormatter); this build encodes the documented
BSON spec directly — the subset a row sink needs: double, string, document,
array, binary, bool, UTC datetime, null, int32/int64.
"""

from __future__ import annotations

import datetime
import struct
from typing import Any


def encode_document(doc: dict) -> bytes:
    body = b"".join(_encode_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _cstring(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _encode_element(name: str, v: Any) -> bytes:
    key = _cstring(name)
    if v is None:
        return b"\x0a" + key
    if isinstance(v, bool):
        return b"\x08" + key + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + key + struct.pack("<i", v)
        if -(2**63) <= v < 2**63:
            return b"\x12" + key + struct.pack("<q", v)
        return b"\x01" + key + struct.pack("<d", float(v))
    if isinstance(v, float):
        return b"\x01" + key + struct.pack("<d", v)
    if isinstance(v, str):
        data = v.encode("utf-8")
        return b"\x02" + key + struct.pack("<i", len(data) + 1) + data + b"\x00"
    if isinstance(v, bytes):
        return b"\x05" + key + struct.pack("<i", len(v)) + b"\x00" + v
    if isinstance(v, datetime.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        millis = int(v.timestamp() * 1000)
        return b"\x09" + key + struct.pack("<q", millis)
    if isinstance(v, (list, tuple)):
        arr = {str(i): x for i, x in enumerate(v)}
        return b"\x04" + key + encode_document(arr)
    if isinstance(v, dict):
        return b"\x03" + key + encode_document(v)
    # fallback: stringified
    return _encode_element(name, str(v))


def decode_document(data: bytes, offset: int = 0) -> tuple[dict, int]:
    (length,) = struct.unpack_from("<i", data, offset)
    end = offset + length - 1  # trailing \x00
    pos = offset + 4
    out: dict = {}
    while pos < end:
        tag = data[pos]
        pos += 1
        zero = data.index(b"\x00", pos)
        name = data[pos:zero].decode("utf-8")
        pos = zero + 1
        if tag == 0x0A:
            out[name] = None
        elif tag == 0x08:
            out[name] = data[pos] == 1
            pos += 1
        elif tag == 0x10:
            (out[name],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif tag == 0x12:
            (out[name],) = struct.unpack_from("<q", data, pos)
            pos += 8
        elif tag == 0x01:
            (out[name],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif tag == 0x02:
            (slen,) = struct.unpack_from("<i", data, pos)
            pos += 4
            out[name] = data[pos : pos + slen - 1].decode("utf-8")
            pos += slen
        elif tag == 0x05:
            (blen,) = struct.unpack_from("<i", data, pos)
            pos += 5  # length + subtype byte
            out[name] = data[pos : pos + blen]
            pos += blen
        elif tag == 0x09:
            (millis,) = struct.unpack_from("<q", data, pos)
            pos += 8
            out[name] = datetime.datetime.fromtimestamp(
                millis / 1000.0, tz=datetime.timezone.utc
            )
        elif tag in (0x03, 0x04):
            sub, pos = decode_document(data, pos)
            out[name] = list(sub.values()) if tag == 0x04 else sub
        else:
            raise ValueError(f"unsupported BSON tag 0x{tag:02x} for {name!r}")
    return out, end + 1
