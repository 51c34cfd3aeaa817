"""Minimal Apache Avro binary codec (object container files).

Iceberg's manifest lists and manifest files are Avro container files
(``src/connectors/data_lake/iceberg.rs`` reads them via the
iceberg crate); this module implements the documented Avro spec subset the
Iceberg metadata needs — null/boolean/int/long/float/double/bytes/string,
records, arrays, maps, unions, fixed, enum — with schema-driven encode and
writer-schema-driven decode.  Codec ``null`` (uncompressed) only.
"""

from __future__ import annotations

import json as _json
import os
import struct
from typing import Any

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# primitive encoding
# ---------------------------------------------------------------------------


def enc_long(n: int) -> bytes:
    # zigzag then varint
    z = (n << 1) ^ (n >> 63)
    z &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def enc_bytes(b: bytes) -> bytes:
    return enc_long(len(b)) + b


def enc_str(s: str) -> bytes:
    return enc_bytes(s.encode("utf-8"))


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def long(self) -> int:
        shift, acc = 0, 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")


# ---------------------------------------------------------------------------
# schema-driven encode / decode
# ---------------------------------------------------------------------------


def encode(schema: Any, value: Any) -> bytes:
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):  # union: pick the branch by value
        for i, branch in enumerate(schema):
            if _matches(branch, value):
                return enc_long(i) + encode(branch, value)
        raise ValueError(f"value {value!r} matches no union branch {schema!r}")
    else:
        t = schema["type"]
        if isinstance(t, list):
            return encode(t, value)
    if t == "null":
        return b""
    if t == "boolean":
        return b"\x01" if value else b"\x00"
    if t in ("int", "long"):
        return enc_long(int(value))
    if t == "float":
        return struct.pack("<f", float(value))
    if t == "double":
        return struct.pack("<d", float(value))
    if t == "bytes":
        return enc_bytes(bytes(value))
    if t == "string":
        return enc_str(str(value))
    if t == "fixed":
        data = bytes(value)
        if len(data) != schema["size"]:
            raise ValueError("fixed size mismatch")
        return data
    if t == "enum":
        return enc_long(schema["symbols"].index(value))
    if t == "record":
        out = b""
        for field in schema["fields"]:
            fv = value.get(field["name"], field.get("default"))
            out += encode(field["type"], fv)
        return out
    if t == "array":
        items = list(value or [])
        out = b""
        if items:
            out += enc_long(len(items))
            for it in items:
                out += encode(schema["items"], it)
        return out + enc_long(0)
    if t == "map":
        entries = dict(value or {})
        out = b""
        if entries:
            out += enc_long(len(entries))
            for k, v in entries.items():
                out += enc_str(k) + encode(schema["values"], v)
        return out + enc_long(0)
    raise ValueError(f"unsupported avro type {t!r}")


def _matches(branch: Any, value: Any) -> bool:
    t = branch if isinstance(branch, str) else branch.get("type")
    if t == "null":
        return value is None
    return value is not None


def decode(schema: Any, r: _Reader) -> Any:
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):
        return decode(schema[r.long()], r)
    else:
        t = schema["type"]
        if isinstance(t, list):
            return decode(t, r)
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) == b"\x01"
    if t in ("int", "long"):
        return r.long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.bytes_()
    if t == "string":
        return r.str_()
    if t == "fixed":
        return r.read(schema["size"])
    if t == "enum":
        return schema["symbols"][r.long()]
    if t == "record":
        return {f["name"]: decode(f["type"], r) for f in schema["fields"]}
    if t == "array":
        out = []
        while True:
            n = r.long()
            if n == 0:
                return out
            if n < 0:  # block with byte size prefix
                r.long()
                n = -n
            for _ in range(n):
                out.append(decode(schema["items"], r))
    if t == "map":
        out = {}
        while True:
            n = r.long()
            if n == 0:
                return out
            if n < 0:
                r.long()
                n = -n
            for _ in range(n):
                # key must read before value (dict stores evaluate the
                # value expression first)
                key = r.str_()
                out[key] = decode(schema["values"], r)
    raise ValueError(f"unsupported avro type {t!r}")


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------

_SYNC = b"\x50\x41\x54\x48\x57\x41\x59\x5f\x54\x50\x55\x5f\x41\x56\x52\x4f"  # 16B


def write_container(path: str, schema: Any, records: list[Any]) -> None:
    body = b"".join(encode(schema, rec) for rec in records)
    header = MAGIC
    meta = {
        "avro.schema": _json.dumps(schema).encode(),
        "avro.codec": b"null",
    }
    header += enc_long(len(meta))
    for k, v in meta.items():
        header += enc_str(k) + enc_bytes(v)
    header += enc_long(0)
    header += _SYNC
    block = enc_long(len(records)) + enc_long(len(body)) + body + _SYNC
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header + (block if records else b""))
    os.replace(tmp, path)


def read_container(path: str) -> list[Any]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    r = _Reader(data, 4)
    meta: dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            r.long()
            n = -n
        for _ in range(n):
            # sequence the reads explicitly: in `d[k()] = v()` Python
            # evaluates the VALUE first, which would read the stream
            # out of order
            key = r.str_()
            meta[key] = r.bytes_()
    codec = meta.get("avro.codec", b"null")
    if codec not in (b"null", b""):
        raise ValueError(f"unsupported avro codec {codec!r}")
    schema = _json.loads(meta["avro.schema"])
    sync = r.read(16)
    out: list[Any] = []
    while r.pos < len(data):
        count = r.long()
        _size = r.long()
        for _ in range(count):
            out.append(decode(schema, r))
        if r.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return out
