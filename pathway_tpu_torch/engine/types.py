"""Core value/key model of the TPU-native engine.

Design notes (reference parity):
  * Pathway keys every row with a 128-bit key whose low 16 bits select the data
    shard (``src/engine/value.rs:38,41``).  We keep the same
    128-bit key space and shard mask so multi-worker exchange semantics match,
    but keys live as Python ints host-side (arbitrary-precision, hash-friendly)
    and are split into (hi, lo) uint64 pairs when they cross into device code.
  * ``Value`` in the reference is a Rust enum (``value.rs:207-228``).  Here the
    host runtime is Python, so values are plain Python objects; this module
    pins down the *canonical* representations and the stable hash used for key
    derivation so results are reproducible across workers and processes.

Timestamps: u64, even = original data, odd = retraction-in-progress, matching
``src/timestamp.rs`` semantics (we only ever emit even times
from connectors; odd times are reserved for the retraction machinery).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Iterable

import numpy as np

# --- key space ---------------------------------------------------------------

KEY_BITS = 128
KEY_MASK = (1 << KEY_BITS) - 1
SHARD_BITS = 16
SHARD_MASK = (1 << SHARD_BITS) - 1  # value.rs:38

Time = int  # u64 epoch counter; even = original, odd = retraction
Diff = int  # signed multiplicity

ARTIFICIAL_TIME_ON_REWIND_START = 0


def shard_of(key: int) -> int:
    """Shard field of a 128-bit key (low 16 bits), as in value.rs:76."""
    return key & SHARD_MASK


def shard_to_worker(key: int, worker_count: int) -> int:
    # routing rule: k.shard_as_usize() % worker_count (dataflow.rs:1414)
    return (key & SHARD_MASK) % worker_count


class Pointer:
    """User-visible row id wrapper (mirrors ``pw.Pointer``).

    Compares/hashes by the underlying 128-bit int so it can key dicts and be
    stored in tables like any other value.
    """

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value & KEY_MASK

    def __repr__(self) -> str:  # short, stable, prints like ^XXXX
        return "^" + _b32(self.value)

    def __hash__(self) -> int:
        return hash(self.value)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Pointer) and other.value == self.value

    def __lt__(self, other: "Pointer") -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value < other.value

    def __le__(self, other: "Pointer") -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value <= other.value

    def __gt__(self, other: "Pointer") -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value > other.value

    def __ge__(self, other: "Pointer") -> bool:
        if not isinstance(other, Pointer):
            return NotImplemented
        return self.value >= other.value


_B32 = "0123456789ABCDEFGHIJKLMNOPQRSTUV"


def _b32(v: int) -> str:
    out = []
    for _ in range(8):  # print 40 bits; enough to disambiguate in debug output
        out.append(_B32[v & 31])
        v >>= 5
    return "".join(reversed(out))


class Error:
    """Singleton error value (``Value::Error`` poisoning, value.rs:226)."""

    _instance: "Error | None" = None

    def __new__(cls) -> "Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        raise TypeError("cannot use pw Error value in a boolean context")

    def __reduce__(self):
        # keep singleton identity across the worker exchange (pickle)
        return (Error, ())


ERROR = Error()


class Json:
    """Wrapper marking a value as JSON-typed (mirrors pw.Json)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        if isinstance(value, Json):
            value = value.value
        self.value = value

    def __repr__(self) -> str:
        import json as _json

        return _json.dumps(self.value)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Json) and other.value == self.value

    def __hash__(self) -> int:
        return hash(repr(self))

    # convenience accessors mirroring pathway's Json API
    def as_int(self):
        return int(self.value)

    def as_float(self):
        return float(self.value)

    def as_str(self):
        return str(self.value)

    def as_bool(self):
        return bool(self.value)

    def as_list(self):
        return list(self.value)

    def as_dict(self):
        return dict(self.value)

    def __getitem__(self, item):
        return Json(self.value[item])

    @staticmethod
    def parse(s: str) -> "Json":
        import json as _json

        return Json(_json.loads(s))

    NULL: "Json"


Json.NULL = Json(None)


class PyObjectWrapper:
    """Opaque Python object carried through the engine (value.rs:228)."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, serializer: Any = None):
        self.value = value
        self._serializer = serializer

    def __repr__(self) -> str:
        return f"PyObjectWrapper({self.value!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PyObjectWrapper) and other.value == self.value

    def __hash__(self) -> int:
        try:
            return hash(self.value)
        except TypeError:
            return hash(id(self.value))


def wrap_py_object(value: Any, *, serializer: Any = None) -> PyObjectWrapper:
    return PyObjectWrapper(value, serializer=serializer)


class HashableNDArray(np.ndarray):
    """ndarray view hashable/equatable by contents.

    The reference's ``Value::IntArray/FloatArray`` are hashable by contents
    (value.rs HashInto); engine state (consolidation counters, arrangement
    keys) requires the same here.  ``==`` returns a bool (contents equal),
    not an elementwise array — inside engine rows arrays are *values*.
    Arithmetic and numpy ops still work (it is an ndarray view).
    """

    def __hash__(self):  # type: ignore[override]
        return hash(
            (
                self.shape,
                str(self.dtype),
                hashlib.blake2b(
                    np.ascontiguousarray(self).tobytes(), digest_size=8
                ).digest(),
            )
        )

    def __eq__(self, other):  # type: ignore[override]
        # strict: dtype is part of identity, matching __hash__ (hash/eq
        # contract) — dtype coercion normalizes values before they enter rows
        if isinstance(other, np.ndarray):
            return (
                self.shape == other.shape
                and self.dtype == other.dtype
                and bool(np.array_equal(np.asarray(self), np.asarray(other)))
            )
        return NotImplemented

    def __ne__(self, other):  # type: ignore[override]
        res = self.__eq__(other)
        if res is NotImplemented:
            return res
        return not res


def as_hashable(value: Any) -> Any:
    """Wrap ndarrays into the hashable view, recursing into tuples (idempotent)."""
    if isinstance(value, np.ndarray) and not isinstance(value, HashableNDArray):
        return value.view(HashableNDArray)
    if isinstance(value, tuple) and any(
        isinstance(v, (np.ndarray, tuple)) for v in value
    ):
        return tuple(as_hashable(v) for v in value)
    return value


# --- stable hashing / key derivation ----------------------------------------
#
# The reference derives keys with xxh3-128 over a serialized value sequence
# (value.rs "HashInto").  We use blake2b-128 host-side: stable across runs,
# processes and machines, which is the property the engine actually needs.


def _hash_bytes(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=16).digest(), "little")


def _ser_value(v: Any, out: list[bytes]) -> None:
    if v is None:
        out.append(b"\x00")
    elif v is True:
        out.append(b"\x01\x01")
    elif v is False:
        out.append(b"\x01\x00")
    elif isinstance(v, int):
        out.append(b"\x02" + v.to_bytes(16, "little", signed=True))
    elif isinstance(v, float):
        out.append(b"\x03" + struct.pack("<d", v))
    elif isinstance(v, str):
        b = v.encode()
        out.append(b"\x04" + len(b).to_bytes(8, "little") + b)
    elif isinstance(v, bytes):
        out.append(b"\x05" + len(v).to_bytes(8, "little") + v)
    elif isinstance(v, Pointer):
        out.append(b"\x06" + v.value.to_bytes(16, "little"))
    elif isinstance(v, tuple):
        out.append(b"\x07" + len(v).to_bytes(8, "little"))
        for item in v:
            _ser_value(item, out)
    elif isinstance(v, np.ndarray):
        out.append(b"\x08" + str(v.dtype).encode() + str(v.shape).encode())
        out.append(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, Json):
        import json as _json

        b = _json.dumps(v.value, sort_keys=True).encode()
        out.append(b"\x09" + b)
    elif isinstance(v, PyObjectWrapper):
        out.append(b"\x0b" + repr(v.value).encode())
    else:  # datetimes, durations, anything reprable
        out.append(b"\x0a" + type(v).__name__.encode() + b":" + repr(v).encode())


_native_mod: Any = None
_native_checked = False


def _native():
    """The compiled runtime core (pathway_tpu_torch/native), or None."""
    global _native_mod, _native_checked
    if not _native_checked:
        from pathway_tpu_torch import native as _n

        _native_mod = _n.get()
        _native_checked = True
    return _native_mod


def hash_values(values: Iterable[Any]) -> int:
    """Stable 128-bit hash of a value sequence (key derivation)."""
    native = _native()
    if native is not None:
        return native.hash_values(tuple(values))
    out: list[bytes] = []
    for v in values:
        _ser_value(v, out)
    return _hash_bytes(b"".join(out))


def hash_values_py(values: Iterable[Any]) -> int:
    """Pure-Python reference path (native parity tests)."""
    out: list[bytes] = []
    for v in values:
        _ser_value(v, out)
    return _hash_bytes(b"".join(out))


_SEQ_SALT = b"pathway_tpu:sequential"


def ref_scalar(*values: Any, optional: bool = False) -> Pointer:
    """Derive a Pointer from primary-key values (pw api.ref_scalar)."""
    if optional and any(v is None for v in values):
        return None  # type: ignore[return-value]
    return Pointer(hash_values(values))


def sequential_key(seq: int) -> int:
    """Key for auto-numbered rows (connector autogenerate / unsafe_trusted_ids)."""
    return _hash_bytes(_SEQ_SALT + seq.to_bytes(16, "little", signed=True))


def sequential_keys(start: int, count: int) -> list[int]:
    """Bulk ``[sequential_key(start + i) for i in range(count)]`` — the
    native core derives them in one C loop (bulk-ingest hot path)."""
    native = _native()
    if native is not None and hasattr(native, "sequential_keys"):
        return native.sequential_keys(
            _SEQ_SALT, start.to_bytes(16, "little", signed=True), count
        )
    return [sequential_key(start + i) for i in range(count)]


def key_to_u64_pair(key: int) -> tuple[int, int]:
    """Split a 128-bit key into (hi, lo) uint64 for device-side id tensors."""
    return (key >> 64) & 0xFFFFFFFFFFFFFFFF, key & 0xFFFFFFFFFFFFFFFF


def u64_pair_to_key(hi: int, lo: int) -> int:
    return ((int(hi) & 0xFFFFFFFFFFFFFFFF) << 64) | (int(lo) & 0xFFFFFFFFFFFFFFFF)
