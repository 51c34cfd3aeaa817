"""Binary codec for engine values, rows and snapshot events.

Parity target: the reference serializes snapshot entries with bincode over
its ``Value`` enum (``src/persistence/input_snapshot.rs:32-36``,
``src/engine/value.rs:207-228``).  This is the TPU build's equivalent wire
format: a compact tagged binary encoding covering every engine value type.
The framing is deliberately simple (tag byte + little-endian fixed ints +
length-prefixed payloads) so the hot paths can be implemented in the native
C++ runtime (``native/``) behind the same interface.

Events (the snapshot log unit, input_snapshot.rs Event enum):
  Insert(key, values) / Delete(key, values) / AdvanceTime(t) / Finished.

One departure from ``pathway_tpu/engine/codec.py``: an array of an
``ml_dtypes`` dtype (a bf16 UDF result) is written under the dtype's name,
so it crosses the mesh and a snapshot as ``bfloat16`` with its bits; the
JAX package writes its void ``str`` and reads back raw ``|V2`` bytes.
"""

from __future__ import annotations

import datetime as _dt
import io as _io
import json as _json
import pickle
import struct
import threading as _threading
from typing import Any, Iterable

import numpy as np

from pathway_tpu_torch.engine.types import (
    ERROR,
    Error,
    Json,
    Pointer,
    PyObjectWrapper,
    as_hashable,
)

MAGIC = b"PWT1"  # codec version tag; bump on format change


# --- integrity framing -------------------------------------------------------
#
# Every blob the persistence layer writes (snapshot chunks, generation
# manifests, operator dumps) is wrapped in a self-checking frame so a torn
# write, a truncation, or a bit-flip on the storage medium is DETECTED at
# read time instead of silently corrupting recovered state:
#
#   magic "PWF1" | version u8 | payload length u64 LE | CRC32C u32 LE | payload
#
# CRC32C (Castagnoli) matches what object stores expose natively
# (x-goog-hash / x-amz-checksum-crc32c), so a future backend can delegate
# the check to the store.  The polynomial also guarantees detection of any
# single-bit flip and any burst shorter than 32 bits.

FRAME_MAGIC = b"PWF1"
FRAME_VERSION = 1
_FRAME_HEADER = struct.Struct("<4sBQI")
FRAME_OVERHEAD = _FRAME_HEADER.size


class IntegrityError(ValueError):
    """A persisted artifact failed its integrity frame check."""


_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli
_crc32c_table: list[int] | None = None


def _crc32c_make_table() -> list[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        table.append(crc)
    return table


class _Crc32cEngine:
    """Vectorized CRC-32C.

    A pure-python byte loop runs at ~4 MB/s — far too slow to frame every
    checkpoint chunk on the hot commit path.  CRC is *linear* over GF(2):
    with the reflected update ``step(s, b) = step0(s) ^ T[b]`` (where
    ``step0`` advances the register by one zero byte and ``T`` is the
    byte table, itself linear), the register after a K-byte block is

        step0^K(s_in)  XOR  XOR_j step0^(K-1-j)(T[b_j])

    so per block we need (a) one gather over K precomputed *positional*
    tables — a single numpy fancy-index + xor-reduce — and (b) the linear
    operator ``step0^K`` applied to the carried register via its images of
    the 32 basis bits.  Measured ~60 MB/s on MB-scale blobs (~15x the byte
    loop), exact CRC-32C semantics (verified against the canonical check
    value in the test suite).
    """

    # positional-table span: 512 keeps typical snapshot chunks (sub-KB) on
    # the vectorized path while the table set stays at 512 KB; measured
    # ~60 MB/s on MB-scale blobs vs ~4 MB/s for the plain byte loop
    BLOCK = 512
    _SLAB = 512  # blocks gathered per numpy call: bounds scratch at ~1 MB

    def __init__(self):
        self.table = np.array(_crc32c_make_table(), dtype=np.uint32)
        self.pos_tables: Any = None  # (BLOCK, 256) uint32, built lazily
        self.advance_basis: Any = None  # step0^BLOCK images of the 32 bits
        # reentrant: CRC verification runs on the SIGUSR1 flight-recorder
        # dump path (lease read → unframe), which may interrupt the main
        # thread mid-build while it holds this lock.  The build is
        # idempotent and publishes pos_tables LAST, so a reentrant
        # rebuild is wasted work, never a torn table — while a plain
        # Lock here would deadlock the handler (the PR-3 lazy-table race,
        # signal edition).
        self._build_lock = _threading.RLock()

    def _step0_vec(self, v):
        return (v >> np.uint32(8)) ^ self.table[v & np.uint32(0xFF)]

    def _build(self) -> None:
        tabs = np.empty((self.BLOCK, 256), dtype=np.uint32)
        cur = self.table.copy()  # contribution of the block's LAST byte
        tabs[self.BLOCK - 1] = cur
        for j in range(self.BLOCK - 2, -1, -1):
            cur = self._step0_vec(cur)
            tabs[j] = cur
        basis = np.array([1 << i for i in range(32)], dtype=np.uint32)
        for _ in range(self.BLOCK):
            basis = self._step0_vec(basis)
        self.advance_basis = [int(x) for x in basis]
        # publish pos_tables LAST: concurrent update() calls gate on it, so
        # advance_basis must already be visible (the checkpoint writer pool
        # frames chunks from several threads at once)
        self.pos_tables = tabs

    def _advance(self, state: int) -> int:
        """Apply ``step0^BLOCK`` to a 32-bit register via its basis images."""
        out = 0
        basis = self.advance_basis
        i = 0
        while state:
            if state & 1:
                out ^= basis[i]
            state >>= 1
            i += 1
        return out

    def update_bytes(self, state: int, data) -> int:
        """The classic per-byte loop (used for tails and small inputs)."""
        table = self.table
        for b in data:
            state = int(table[(state ^ b) & 0xFF]) ^ (state >> 8)
        return state

    def update(self, state: int, data: bytes) -> int:
        n_blocks, tail = divmod(len(data), self.BLOCK)
        if n_blocks == 0:
            return self.update_bytes(state, data)
        if self.pos_tables is None:
            with self._build_lock:
                if self.pos_tables is None:
                    self._build()
        arr = np.frombuffer(data, dtype=np.uint8, count=n_blocks * self.BLOCK)
        arr = arr.reshape(n_blocks, self.BLOCK)
        pos = np.arange(self.BLOCK)[None, :]
        contribs = np.empty(n_blocks, dtype=np.uint32)
        for lo in range(0, n_blocks, self._SLAB):
            hi = min(lo + self._SLAB, n_blocks)
            gathered = self.pos_tables[pos, arr[lo:hi]]
            contribs[lo:hi] = np.bitwise_xor.reduce(gathered, axis=1)
        for c in contribs:
            state = self._advance(state) ^ int(c)
        if tail:
            state = self.update_bytes(state, data[n_blocks * self.BLOCK :])
        return state


_crc32c_engine: _Crc32cEngine | None = None
# reentrant: crc32c() is reachable from the SIGUSR1 handler (see
# _ResolvingTable note above) — engine construction is idempotent
_crc32c_engine_lock = _threading.RLock()


def crc32c(data: bytes | memoryview, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``; chainable via the ``crc`` arg.
    Native path: hardware SSE4.2 CRC with the GIL released (GB/s — the
    writer pool frames chunks truly concurrently with the epoch loop);
    the vectorized-numpy engine below is the fallback.  Thread-safe:
    engines and their lazy tables build exactly once."""
    from pathway_tpu_torch.engine.types import _native

    native = _native()
    if native is not None and hasattr(native, "crc32c"):
        # no bytes() copy: the native side takes any C-contiguous buffer
        # ("y*"), and copying MB-scale chunks here (under the GIL) would
        # re-serialize the writer-pool threads the native path unblocks
        return native.crc32c(data, crc)
    global _crc32c_engine
    engine = _crc32c_engine
    if engine is None:
        with _crc32c_engine_lock:
            if _crc32c_engine is None:
                _crc32c_engine = _Crc32cEngine()
            engine = _crc32c_engine
    state = ~crc & 0xFFFFFFFF
    state = engine.update(state, bytes(data))
    return ~state & 0xFFFFFFFF


def frame_blob(payload: bytes) -> bytes:
    """Wrap ``payload`` in the self-checking integrity frame."""
    return (
        _FRAME_HEADER.pack(
            FRAME_MAGIC, FRAME_VERSION, len(payload), crc32c(payload)
        )
        + payload
    )


def unframe_blob(
    data: bytes,
    *,
    what: str = "blob",
    allow_legacy: bool = False,
    verify_crc: bool = True,
) -> bytes:
    """Validate and strip the integrity frame; raises :class:`IntegrityError`.

    ``allow_legacy=True`` passes through blobs written before framing
    existed (no magic) unchanged — used only on migration read paths where
    the manifest records no digest for the artifact.

    ``verify_crc=False`` still validates the header/length (torn writes)
    but skips the checksum — for callers that already compared the blob
    against its manifest-pinned SHA-256 digest, which is strictly stronger
    than the frame CRC.
    """
    if len(data) < FRAME_OVERHEAD or data[:4] != FRAME_MAGIC:
        if allow_legacy and len(data) > 0 and data[:4] != FRAME_MAGIC:
            # legacy artifacts are never empty (chunks always hold >= 1
            # event): a zero-byte blob is a torn create, not legacy data
            return data
        raise IntegrityError(
            f"codec: {what}: missing or mangled integrity frame header "
            f"({len(data)} byte(s), magic {bytes(data[:4])!r})"
        )
    _magic, version, length, crc = _FRAME_HEADER.unpack_from(data)
    if version != FRAME_VERSION:
        raise IntegrityError(
            f"codec: {what}: unsupported frame version {version} "
            f"(this build reads version {FRAME_VERSION})"
        )
    payload = data[FRAME_OVERHEAD:]
    if len(payload) != length:
        raise IntegrityError(
            f"codec: {what}: torn or truncated payload — frame declares "
            f"{length} byte(s), found {len(payload)}"
        )
    if not verify_crc:
        return payload
    actual = crc32c(payload)
    if actual != crc:
        raise IntegrityError(
            f"codec: {what}: CRC32C mismatch (stored {crc:#010x}, "
            f"computed {actual:#010x}) — bit rot or a torn write"
        )
    return payload

# value tags
_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3  # 8-byte signed
_T_BIGINT = 4  # length-prefixed signed big int
_T_FLOAT = 5
_T_STR = 6
_T_BYTES = 7
_T_POINTER = 8  # 16-byte little-endian u128
_T_TUPLE = 9
_T_NDARRAY = 10
_T_JSON = 11
_T_DATETIME_NAIVE = 12  # microseconds since epoch, 8-byte signed
_T_DATETIME_UTC = 13
_T_DURATION = 14  # microseconds, 8-byte signed
_T_ERROR = 15
_T_PYOBJECT = 16  # pickled (opaque fallback; decodes to the raw object)
_T_DATE = 17
_T_LIST = 18  # same layout as _T_TUPLE; decodes back to a list
_T_PYOBJECT_WRAPPED = 19  # pickled PyObjectWrapper.value; re-wrapped on decode

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_EPOCH_NAIVE = _dt.datetime(1970, 1, 1)
_EPOCH_UTC = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _w_len(out: _io.BytesIO, n: int) -> None:
    out.write(_U64.pack(n))


def encode_value(v: Any, out: _io.BytesIO) -> None:
    if v is None:
        out.write(bytes([_T_NONE]))
    elif v is True:
        out.write(bytes([_T_TRUE]))
    elif v is False:
        out.write(bytes([_T_FALSE]))
    elif isinstance(v, int):
        if -(2**63) <= v < 2**63:
            out.write(bytes([_T_INT]))
            out.write(_I64.pack(v))
        else:
            b = v.to_bytes((v.bit_length() + 8) // 8 + 1, "little", signed=True)
            out.write(bytes([_T_BIGINT]))
            _w_len(out, len(b))
            out.write(b)
    elif isinstance(v, float):
        out.write(bytes([_T_FLOAT]))
        out.write(_F64.pack(v))
    elif isinstance(v, str):
        b = v.encode()
        out.write(bytes([_T_STR]))
        _w_len(out, len(b))
        out.write(b)
    elif isinstance(v, bytes):
        out.write(bytes([_T_BYTES]))
        _w_len(out, len(v))
        out.write(v)
    elif isinstance(v, Pointer):
        out.write(bytes([_T_POINTER]))
        out.write(v.value.to_bytes(16, "little"))
    elif isinstance(v, (tuple, list)):
        # lists get their own tag (same layout) so they round-trip as
        # lists: falling to the pickle tail would make delta buckets
        # opaque on the comm wire, and decoding them as tuples would make
        # value shapes differ between local and exchanged rows
        out.write(bytes([_T_TUPLE if isinstance(v, tuple) else _T_LIST]))
        _w_len(out, len(v))
        for item in v:
            encode_value(item, out)
    elif isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        dt = arr.dtype
        # an ml_dtypes dtype (bfloat16, the float8s) has a void ``str``
        # (``<V2``) that would decode as raw bytes: its name keeps it
        named = dt.kind == "V" and dt.names is None and dt.type.__module__ == "ml_dtypes"
        dts = (dt.name if named else dt.str).encode()
        shape = arr.shape
        out.write(bytes([_T_NDARRAY]))
        _w_len(out, len(dts))
        out.write(dts)
        _w_len(out, len(shape))
        for s in shape:
            out.write(_U64.pack(s))
        payload = arr.tobytes()
        _w_len(out, len(payload))
        out.write(payload)
    elif isinstance(v, Json):
        b = _json.dumps(v.value, sort_keys=True).encode()
        out.write(bytes([_T_JSON]))
        _w_len(out, len(b))
        out.write(b)
    elif isinstance(v, _dt.datetime):
        if v.tzinfo is None:
            out.write(bytes([_T_DATETIME_NAIVE]))
            micros = round((v - _EPOCH_NAIVE).total_seconds() * 1e6)
        else:
            out.write(bytes([_T_DATETIME_UTC]))
            micros = round((v - _EPOCH_UTC).total_seconds() * 1e6)
        out.write(_I64.pack(micros))
    elif isinstance(v, _dt.date):
        out.write(bytes([_T_DATE]))
        out.write(_I64.pack(v.toordinal()))
    elif isinstance(v, _dt.timedelta):
        out.write(bytes([_T_DURATION]))
        out.write(_I64.pack(round(v.total_seconds() * 1e6)))
    elif isinstance(v, Error):
        out.write(bytes([_T_ERROR]))
    elif isinstance(v, PyObjectWrapper):
        # distinct tag so decode re-wraps: wrapper equality must survive a
        # round trip (an exchanged retraction has to cancel a local insert)
        b = pickle.dumps(v.value)
        out.write(bytes([_T_PYOBJECT_WRAPPED]))
        _w_len(out, len(b))
        out.write(b)
    else:  # last resort: opaque pickle (keeps UDF-produced objects alive)
        b = pickle.dumps(v)
        out.write(bytes([_T_PYOBJECT]))
        _w_len(out, len(b))
        out.write(b)


def _r_len(buf: memoryview, pos: int) -> tuple[int, int]:
    return _U64.unpack_from(buf, pos)[0], pos + 8


def _take(buf: memoryview, pos: int, n: int) -> tuple[memoryview, int]:
    # subtraction form: corrupted length fields near u64::MAX must not
    # silently produce a short slice (matches the native Cursor::need)
    if pos > len(buf) or n > len(buf) - pos:
        raise ValueError("codec: truncated buffer")
    return buf[pos : pos + n], pos + n


def decode_value(
    buf: memoryview, pos: int, *, allow_pyobject: bool = True
) -> tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag in (_T_PYOBJECT, _T_PYOBJECT_WRAPPED) and not allow_pyobject:
        raise ValueError(
            "codec: python-object (pickled) value refused by typed-only "
            "decode — on the comm mesh this means a PyObjectWrapper row "
            "crossed an unauthenticated link; set PATHWAY_COMM_SECRET"
        )
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == _T_BIGINT:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return int.from_bytes(b, "little", signed=True), pos
    if tag == _T_FLOAT:
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag == _T_STR:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return bytes(b).decode(), pos
    if tag == _T_BYTES:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return bytes(b), pos
    if tag == _T_POINTER:
        b, pos = _take(buf, pos, 16)
        return Pointer(int.from_bytes(b, "little")), pos
    if tag in (_T_TUPLE, _T_LIST):
        n, pos = _r_len(buf, pos)
        items = []
        for _ in range(n):
            item, pos = decode_value(buf, pos, allow_pyobject=allow_pyobject)
            items.append(item)
        return (tuple(items) if tag == _T_TUPLE else items), pos
    if tag == _T_NDARRAY:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        dts = bytes(b).decode()
        ndim, pos = _r_len(buf, pos)
        shape = []
        for _ in range(ndim):
            shape.append(_U64.unpack_from(buf, pos)[0])
            pos += 8
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        if dts[:1] not in "<>|=":  # a dtype by name: ml_dtypes registers it
            import ml_dtypes  # noqa: F401

        arr = np.frombuffer(b, dtype=np.dtype(dts)).reshape(shape)
        return as_hashable(arr.copy()), pos
    if tag == _T_JSON:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return Json(_json.loads(bytes(b).decode())), pos
    if tag == _T_DATETIME_NAIVE:
        micros = _I64.unpack_from(buf, pos)[0]
        return _EPOCH_NAIVE + _dt.timedelta(microseconds=micros), pos + 8
    if tag == _T_DATETIME_UTC:
        micros = _I64.unpack_from(buf, pos)[0]
        return _EPOCH_UTC + _dt.timedelta(microseconds=micros), pos + 8
    if tag == _T_DATE:
        return _dt.date.fromordinal(_I64.unpack_from(buf, pos)[0]), pos + 8
    if tag == _T_DURATION:
        micros = _I64.unpack_from(buf, pos)[0]
        return _dt.timedelta(microseconds=micros), pos + 8
    if tag == _T_ERROR:
        return ERROR, pos
    if tag == _T_PYOBJECT:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return pickle.loads(bytes(b)), pos
    if tag == _T_PYOBJECT_WRAPPED:
        n, pos = _r_len(buf, pos)
        b, pos = _take(buf, pos, n)
        return PyObjectWrapper(pickle.loads(bytes(b))), pos
    raise ValueError(f"codec: unknown value tag {tag}")


def encode_row_py(values: Iterable[Any]) -> bytes:
    out = _io.BytesIO()
    vals = tuple(values)
    _w_len(out, len(vals))
    for v in vals:
        encode_value(v, out)
    return out.getvalue()


def decode_row_py(
    data: bytes | memoryview, pos: int = 0, *, allow_pyobject: bool = True
) -> tuple[tuple, int]:
    buf = memoryview(data)
    try:
        n, pos = _r_len(buf, pos)
        items = []
        for _ in range(n):
            item, pos = decode_value(buf, pos, allow_pyobject=allow_pyobject)
            items.append(item)
    except ValueError:
        raise
    except MemoryError:
        raise
    except Exception as exc:
        # any other decode failure is buffer corruption (bit-rotted dtype
        # strings hit np.dtype's TypeError, mangled pickles raise
        # UnpicklingError, short fixed reads raise struct.error/IndexError)
        # — surface the single documented, catchable error the native
        # decoder also raises
        raise ValueError(f"codec: corrupt buffer ({exc})") from exc
    return tuple(items), pos


def encode_row(values: Iterable[Any]) -> bytes:
    from pathway_tpu_torch.engine.types import _native

    native = _native()
    if native is not None:
        return native.encode_row(tuple(values))
    return encode_row_py(values)


def decode_row(data: bytes | memoryview, pos: int = 0) -> tuple[tuple, int]:
    from pathway_tpu_torch.engine.types import _native

    native = _native()
    if native is not None:
        return native.decode_row(data, pos)
    return decode_row_py(data, pos)


def decode_row_typed(data: bytes | memoryview, pos: int = 0) -> tuple[tuple, int]:
    """Typed-only decode: raises ValueError on pickled (PYOBJECT) values.

    Used by the comm mesh for links without a handshake secret, where a
    pickle payload from the network would be arbitrary code execution.
    Always the Python decoder — the native one has no refusal hook.
    """
    return decode_row_py(data, pos, allow_pyobject=False)


# --- snapshot events ---------------------------------------------------------

EV_INSERT = 1
EV_DELETE = 2
EV_ADVANCE_TIME = 3
EV_FINISHED = 4


def encode_event(kind: int, key: int = 0, row: tuple = (), time: int = 0) -> bytes:
    out = _io.BytesIO()
    out.write(bytes([kind]))
    if kind in (EV_INSERT, EV_DELETE):
        # keys live in the 128-bit key space (value.rs Key = u128); mask
        # defensively so out-of-range ints cannot abort the event loop
        out.write((key & ((1 << 128) - 1)).to_bytes(16, "little", signed=False))
        payload = encode_row(row)
        _w_len(out, len(payload))
        out.write(payload)
    elif kind == EV_ADVANCE_TIME:
        out.write(_U64.pack(time))
    return out.getvalue()


def encode_events(events: Iterable[tuple]) -> bytes:
    """Encode ``(kind, key, row, time)`` tuples into one chunk payload —
    the batched form of :func:`encode_event` (single buffer, native-
    accelerated).  The checkpoint writer pool encodes whole raw-event
    batches through this so the epoch loop never pays the serializer."""
    from pathway_tpu_torch.engine.types import _native

    native = _native()
    if native is not None and hasattr(native, "encode_events"):
        return native.encode_events(
            events if isinstance(events, (list, tuple)) else list(events)
        )
    out = _io.BytesIO()
    for kind, key, row, time in events:
        out.write(encode_event(kind, key, row, time))
    return out.getvalue()


def decode_events(data: bytes):
    """Yield (kind, key, row, time) tuples from a chunk of encoded events.

    Any malformed input — truncation mid-event, a mangled length field, a
    bit-rotted payload — raises the single documented ``ValueError`` the
    snapshot replay path catches; no other exception type escapes.
    """
    buf = memoryview(data)
    pos = 0
    end = len(buf)
    while pos < end:
        try:
            kind = buf[pos]
            pos += 1
            if kind in (EV_INSERT, EV_DELETE):
                piece, pos = _take(buf, pos, 16)
                key = int.from_bytes(piece, "little")
                n, pos = _r_len(buf, pos)
                if n > end - pos:
                    raise ValueError(
                        "codec: event row length field exceeds the chunk "
                        f"({n} > {end - pos} remaining byte(s))"
                    )
                row, row_end = decode_row(buf, pos)
                if row_end != pos + n:
                    # a mangled length field must never silently skip or
                    # swallow trailing events
                    raise ValueError(
                        "codec: event row length field disagrees with the "
                        f"decoded row ({n} declared, {row_end - pos} decoded)"
                    )
                pos = row_end
                yield kind, key, row, 0
            elif kind == EV_ADVANCE_TIME:
                t = _U64.unpack_from(buf, pos)[0]
                pos += 8
                yield kind, 0, (), t
            elif kind == EV_FINISHED:
                yield kind, 0, (), 0
            else:
                raise ValueError(f"codec: unknown event kind {kind}")
        except ValueError:
            raise
        except MemoryError:
            raise
        except Exception as exc:
            # short fixed-width reads raise struct.error/IndexError —
            # surface the one catchable corruption error (decode_row_py
            # applies the same rule per row)
            raise ValueError(f"codec: corrupt event chunk ({exc})") from exc
