// Native runtime core for pathway_tpu_torch.
//
// Parity role: the reference implements its value model, key derivation and
// snapshot serialization in Rust (src/engine/value.rs:207-228
// "HashInto" key hashing, bincode snapshot encoding in
// src/persistence/input_snapshot.rs).  This is the TPU build's native
// equivalent: a CPython extension implementing
//
//   * blake2b-128 (RFC 7693) — the stable key-derivation hash,
//     bit-identical to hashlib.blake2b(digest_size=16),
//   * the value-hash serialization of engine/types.py:_ser_value,
//   * the PWT1 row codec of engine/codec.py (encode_row/decode_row),
//
// with fast inline paths for the scalar types that dominate row traffic and
// delegation to registered Python helpers for the long tail (ndarray, Json,
// datetime, pickled objects), so the wire format stays defined in exactly
// one place per type.
//
// Built with plain g++ (no pybind11 in this environment); loaded lazily by
// pathway_tpu_torch/native/__init__.py with a pure-Python fallback.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// blake2b (RFC 7693), single-shot, no key
// ---------------------------------------------------------------------------

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);  // little-endian hosts only (x86/ARM)
  return v;
}

static void b2b_compress(uint64_t h[8], const uint8_t block[128], uint64_t t0,
                         uint64_t t1, bool last) {
  uint64_t v[16], m[16];
  for (int i = 0; i < 8; i++) v[i] = h[i];
  for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
  v[12] ^= t0;
  v[13] ^= t1;
  if (last) v[14] = ~v[14];
  for (int i = 0; i < 16; i++) m[i] = load64(block + 8 * i);

#define G(a, b, c, d, x, y)       \
  v[a] = v[a] + v[b] + (x);       \
  v[d] = rotr64(v[d] ^ v[a], 32); \
  v[c] = v[c] + v[d];             \
  v[b] = rotr64(v[b] ^ v[c], 24); \
  v[a] = v[a] + v[b] + (y);       \
  v[d] = rotr64(v[d] ^ v[a], 16); \
  v[c] = v[c] + v[d];             \
  v[b] = rotr64(v[b] ^ v[c], 63);

  for (int r = 0; r < 12; r++) {
    const uint8_t *s = B2B_SIGMA[r];
    G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
#undef G
  for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

static void blake2b_hash(uint8_t *out, size_t outlen, const uint8_t *in,
                         size_t inlen) {
  uint64_t h[8];
  for (int i = 0; i < 8; i++) h[i] = B2B_IV[i];
  h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;  // param: digest len, fanout=depth=1

  uint64_t t = 0;
  uint8_t block[128];
  while (inlen > 128) {
    t += 128;
    b2b_compress(h, in, t, 0, false);
    in += 128;
    inlen -= 128;
  }
  t += inlen;
  std::memset(block, 0, 128);
  if (inlen) std::memcpy(block, in, inlen);
  b2b_compress(h, block, t, 0, true);

  uint8_t full[64];
  for (int i = 0; i < 8; i++) std::memcpy(full + 8 * i, &h[i], 8);
  std::memcpy(out, full, outlen);
}

// ---------------------------------------------------------------------------
// registered Python classes & helpers (set once via _native.setup(...))
// ---------------------------------------------------------------------------

static PyObject *g_pointer_cls = nullptr;      // engine.types.Pointer
static PyObject *g_json_cls = nullptr;         // engine.types.Json
static PyObject *g_pyobj_cls = nullptr;        // engine.types.PyObjectWrapper
static PyObject *g_ndarray_cls = nullptr;      // numpy.ndarray
static PyObject *g_error_obj = nullptr;        // engine.types.ERROR singleton
static PyObject *g_encode_slow = nullptr;      // value -> bytes (PWT1)
static PyObject *g_decode_slow = nullptr;      // (tag, memoryview, pos) -> (value, pos)
static PyObject *g_ser_slow = nullptr;         // value -> bytes (hash ser)

// value tags shared with engine/codec.py
enum {
  T_NONE = 0, T_FALSE = 1, T_TRUE = 2, T_INT = 3, T_BIGINT = 4, T_FLOAT = 5,
  T_STR = 6, T_BYTES = 7, T_POINTER = 8, T_TUPLE = 9, T_NDARRAY = 10,
  T_JSON = 11, T_DT_NAIVE = 12, T_DT_UTC = 13, T_DURATION = 14, T_ERROR = 15,
  T_PYOBJECT = 16, T_DATE = 17,
};

struct Buf {
  std::vector<uint8_t> d;
  void u8(uint8_t b) { d.push_back(b); }
  void raw(const void *p, size_t n) {
    const uint8_t *q = (const uint8_t *)p;
    d.insert(d.end(), q, q + n);
  }
  void u64(uint64_t v) { raw(&v, 8); }
  void i64(int64_t v) { raw(&v, 8); }
  void f64(double v) { raw(&v, 8); }
};

// append a Python int as 16-byte signed little-endian; returns false+sets
// error on overflow (matching int.to_bytes(16, 'little', signed=True))
static bool append_i128(Buf &out, PyObject *v) {
  int overflow = 0;
  long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (!overflow) {
    if (ll == -1 && PyErr_Occurred()) return false;
    uint8_t bytes[16];
    std::memcpy(bytes, &ll, 8);
    std::memset(bytes + 8, ll < 0 ? 0xFF : 0x00, 8);
    out.raw(bytes, 16);
    return true;
  }
  // v.to_bytes(16, 'little', signed=True); OverflowError propagates, as in
  // the Python serializer
  PyObject *meth = PyObject_GetAttrString(v, "to_bytes");
  if (!meth) return false;
  PyObject *args = Py_BuildValue("(is)", 16, "little");
  PyObject *kwargs = Py_BuildValue("{s:O}", "signed", Py_True);
  PyObject *res = PyObject_Call(meth, args, kwargs);
  Py_DECREF(meth);
  Py_DECREF(args);
  Py_DECREF(kwargs);
  if (!res) return false;  // OverflowError propagates, as in Python
  out.raw(PyBytes_AS_STRING(res), PyBytes_GET_SIZE(res));
  Py_DECREF(res);
  return true;
}

// append Pointer.value as 16-byte unsigned little-endian
static bool append_u128_attr(Buf &out, PyObject *ptr) {
  PyObject *val = PyObject_GetAttrString(ptr, "value");
  if (!val) return false;
  uint64_t lo = 0, hi = 0;
  PyObject *shifted = nullptr;
  lo = PyLong_AsUnsignedLongLongMask(val);
  PyObject *sixtyfour = PyLong_FromLong(64);
  shifted = PyNumber_Rshift(val, sixtyfour);
  Py_DECREF(sixtyfour);
  Py_DECREF(val);
  if (!shifted) return false;
  hi = PyLong_AsUnsignedLongLongMask(shifted);
  Py_DECREF(shifted);
  out.raw(&lo, 8);
  out.raw(&hi, 8);
  return true;
}

// ---------------------------------------------------------------------------
// hash serialization (mirror of engine/types.py:_ser_value)
// ---------------------------------------------------------------------------

static bool ser_value(PyObject *v, Buf &out) {
  if (v == Py_None) {
    out.u8(0x00);
    return true;
  }
  if (v == Py_True) {
    out.u8(0x01);
    out.u8(0x01);
    return true;
  }
  if (v == Py_False) {
    out.u8(0x01);
    out.u8(0x00);
    return true;
  }
  if (PyLong_Check(v)) {
    out.u8(0x02);
    return append_i128(out, v);
  }
  if (PyFloat_Check(v)) {
    out.u8(0x03);
    out.f64(PyFloat_AS_DOUBLE(v));
    return true;
  }
  if (PyUnicode_Check(v)) {
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(v, &n);
    if (!s) return false;
    out.u8(0x04);
    out.u64((uint64_t)n);
    out.raw(s, n);
    return true;
  }
  if (PyBytes_Check(v)) {
    out.u8(0x05);
    out.u64((uint64_t)PyBytes_GET_SIZE(v));
    out.raw(PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
    return true;
  }
  int is_ptr = PyObject_IsInstance(v, g_pointer_cls);
  if (is_ptr < 0) return false;
  if (is_ptr) {
    out.u8(0x06);
    return append_u128_attr(out, v);
  }
  if (PyTuple_Check(v)) {
    out.u8(0x07);
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    out.u64((uint64_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (!ser_value(PyTuple_GET_ITEM(v, i), out)) return false;
    }
    return true;
  }
  // long tail (ndarray, Json, PyObjectWrapper, repr fallback): Python helper
  PyObject *b = PyObject_CallFunctionObjArgs(g_ser_slow, v, nullptr);
  if (!b) return false;
  out.raw(PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
  Py_DECREF(b);
  return true;
}

// hash_values(iterable) -> 128-bit int
static PyObject *py_hash_values(PyObject *, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "hash_values expects a sequence");
  if (!seq) return nullptr;
  Buf out;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!ser_value(PySequence_Fast_GET_ITEM(seq, i), out)) {
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  uint8_t digest[16];
  blake2b_hash(digest, 16, out.d.data(), out.d.size());
  // int.from_bytes(digest, 'little')
  uint64_t lo, hi;
  std::memcpy(&lo, digest, 8);
  std::memcpy(&hi, digest + 8, 8);
  PyObject *plo = PyLong_FromUnsignedLongLong(lo);
  PyObject *phi = PyLong_FromUnsignedLongLong(hi);
  PyObject *sixtyfour = PyLong_FromLong(64);
  PyObject *shifted = PyNumber_Lshift(phi, sixtyfour);
  PyObject *res = PyNumber_Or(shifted, plo);
  Py_DECREF(plo);
  Py_DECREF(phi);
  Py_DECREF(sixtyfour);
  Py_DECREF(shifted);
  return res;
}

// sequential_keys(salt: bytes, start16: bytes, count: int) -> list[int]
// Bulk form of engine/types.py sequential_key: key_i =
// blake2b16(salt + le16(start + i)).  start16 is the 16-byte little-endian
// two's-complement of the starting sequence number; the counter increments
// at byte level so arbitrary (worker-salted, > 2^64) starts stay exact.
static PyObject *py_sequential_keys(PyObject *, PyObject *args) {
  const char *salt;
  Py_ssize_t salt_len;
  const char *start16;
  Py_ssize_t start_len;
  Py_ssize_t count;
  if (!PyArg_ParseTuple(args, "y#y#n", &salt, &salt_len, &start16, &start_len,
                        &count))
    return nullptr;
  if (start_len != 16) {
    PyErr_SetString(PyExc_ValueError, "start must be 16 bytes");
    return nullptr;
  }
  PyObject *out = PyList_New(count);
  if (!out) return nullptr;
  std::vector<uint8_t> buf(static_cast<size_t>(salt_len) + 16);
  std::memcpy(buf.data(), salt, salt_len);
  uint8_t ctr[16];
  std::memcpy(ctr, start16, 16);
  PyObject *sixtyfour = PyLong_FromLong(64);
  for (Py_ssize_t i = 0; i < count; i++) {
    std::memcpy(buf.data() + salt_len, ctr, 16);
    uint8_t digest[16];
    blake2b_hash(digest, 16, buf.data(), buf.size());
    uint64_t lo, hi;
    std::memcpy(&lo, digest, 8);
    std::memcpy(&hi, digest + 8, 8);
    PyObject *key;
    if (hi == 0) {
      key = PyLong_FromUnsignedLongLong(lo);
    } else {
      PyObject *plo = PyLong_FromUnsignedLongLong(lo);
      PyObject *phi = PyLong_FromUnsignedLongLong(hi);
      PyObject *shifted = phi ? PyNumber_Lshift(phi, sixtyfour) : nullptr;
      key = (plo && shifted) ? PyNumber_Or(shifted, plo) : nullptr;
      Py_XDECREF(plo);
      Py_XDECREF(phi);
      Py_XDECREF(shifted);
    }
    if (!key) {
      Py_DECREF(out);
      Py_DECREF(sixtyfour);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, key);
    // little-endian increment with carry
    for (int b = 0; b < 16; b++) {
      if (++ctr[b] != 0) break;
    }
  }
  Py_DECREF(sixtyfour);
  return out;
}

// blake2b_128(data: bytes) -> bytes   (for tests / reuse)
static PyObject *py_blake2b_128(PyObject *, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
  uint8_t digest[16];
  blake2b_hash(digest, 16, (const uint8_t *)view.buf, view.len);
  PyBuffer_Release(&view);
  return PyBytes_FromStringAndSize((const char *)digest, 16);
}

// ---------------------------------------------------------------------------
// PWT1 codec (mirror of engine/codec.py)
// ---------------------------------------------------------------------------

static bool encode_value(PyObject *v, Buf &out) {
  if (v == Py_None) {
    out.u8(T_NONE);
    return true;
  }
  if (v == Py_True) {
    out.u8(T_TRUE);
    return true;
  }
  if (v == Py_False) {
    out.u8(T_FALSE);
    return true;
  }
  if (PyLong_Check(v)) {
    int overflow = 0;
    long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (!overflow) {
      if (ll == -1 && PyErr_Occurred()) return false;
      out.u8(T_INT);
      out.i64(ll);
      return true;
    }
    // big int: length-prefixed signed little-endian, like codec.py
    PyObject *nbits_obj = PyObject_CallMethod(v, "bit_length", nullptr);
    if (!nbits_obj) return false;
    size_t nbits = (size_t)PyLong_AsSize_t(nbits_obj);
    Py_DECREF(nbits_obj);
    if (nbits == (size_t)-1 && PyErr_Occurred()) return false;
    size_t nbytes = (nbits + 8) / 8 + 1;  // (bit_length + 8) // 8 + 1
    PyObject *meth = PyObject_GetAttrString(v, "to_bytes");
    if (!meth) return false;
    PyObject *args = Py_BuildValue("(ns)", (Py_ssize_t)nbytes, "little");
    PyObject *kwargs = Py_BuildValue("{s:O}", "signed", Py_True);
    PyObject *res = PyObject_Call(meth, args, kwargs);
    Py_DECREF(meth);
    Py_DECREF(args);
    Py_DECREF(kwargs);
    if (!res) return false;
    out.u8(T_BIGINT);
    out.u64((uint64_t)PyBytes_GET_SIZE(res));
    out.raw(PyBytes_AS_STRING(res), PyBytes_GET_SIZE(res));
    Py_DECREF(res);
    return true;
  }
  if (PyFloat_Check(v)) {
    out.u8(T_FLOAT);
    out.f64(PyFloat_AS_DOUBLE(v));
    return true;
  }
  if (PyUnicode_Check(v)) {
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(v, &n);
    if (!s) return false;
    out.u8(T_STR);
    out.u64((uint64_t)n);
    out.raw(s, n);
    return true;
  }
  if (PyBytes_Check(v)) {
    out.u8(T_BYTES);
    out.u64((uint64_t)PyBytes_GET_SIZE(v));
    out.raw(PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
    return true;
  }
  int is_ptr = PyObject_IsInstance(v, g_pointer_cls);
  if (is_ptr < 0) return false;
  if (is_ptr) {
    out.u8(T_POINTER);
    return append_u128_attr(out, v);
  }
  if (PyTuple_Check(v)) {
    out.u8(T_TUPLE);
    Py_ssize_t n = PyTuple_GET_SIZE(v);
    out.u64((uint64_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (!encode_value(PyTuple_GET_ITEM(v, i), out)) return false;
    }
    return true;
  }
  if (v == g_error_obj) {
    out.u8(T_ERROR);
    return true;
  }
  // long tail: delegate to Python (ndarray/Json/datetime/pickle)
  PyObject *b = PyObject_CallFunctionObjArgs(g_encode_slow, v, nullptr);
  if (!b) return false;
  out.raw(PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b));
  Py_DECREF(b);
  return true;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli) — hardware SSE4.2 when -march=native provides it,
// slicing-free byte table otherwise.  Releases the GIL: the checkpoint
// writer pool frames chunks concurrently with the epoch loop, and a
// GIL-holding checksum would serialize them right back.
// ---------------------------------------------------------------------------

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

static uint32_t crc32c_table_[256];
static bool crc32c_table_ready_ = false;

static void crc32c_build_table() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
    crc32c_table_[i] = crc;
  }
  crc32c_table_ready_ = true;
}

static uint32_t crc32c_update(uint32_t state, const uint8_t *p, size_t n) {
#if defined(__SSE4_2__)
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    state = (uint32_t)_mm_crc32_u64((uint64_t)state, v);
    p += 8;
    n -= 8;
  }
  while (n--) state = _mm_crc32_u8(state, *p++);
  return state;
#else
  while (n--) state = crc32c_table_[(state ^ *p++) & 0xFF] ^ (state >> 8);
  return state;
#endif
}

// crc32c(bytes_like, crc=0) -> int  (chainable, like codec.crc32c)
static PyObject *py_crc32c(PyObject *, PyObject *args) {
  Py_buffer view;
  unsigned long crc = 0;
  if (!PyArg_ParseTuple(args, "y*|k", &view, &crc)) return nullptr;
  // build the table fallback WHILE STILL HOLDING the GIL: crc32c_update
  // runs GIL-released, and a lazy build there would be a C++ data race
  // between writer-pool threads
  if (!crc32c_table_ready_) crc32c_build_table();
  uint32_t state = ~(uint32_t)crc;
  const uint8_t *p = (const uint8_t *)view.buf;
  size_t n = (size_t)view.len;
  Py_BEGIN_ALLOW_THREADS;
  state = crc32c_update(state, p, n);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong(~state & 0xFFFFFFFFu);
}

// encode_row(tuple_or_seq) -> bytes
static PyObject *py_encode_row(PyObject *, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "encode_row expects a sequence");
  if (!seq) return nullptr;
  Buf out;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  out.u64((uint64_t)n);
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!encode_value(PySequence_Fast_GET_ITEM(seq, i), out)) {
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  return PyBytes_FromStringAndSize((const char *)out.d.data(), out.d.size());
}

// append a Python int's low 128 bits as unsigned little-endian (the
// `key & ((1 << 128) - 1)` masking of codec.encode_event)
static bool append_u128_long(Buf &out, PyObject *val) {
  uint64_t lo = PyLong_AsUnsignedLongLongMask(val);
  if (lo == (uint64_t)-1 && PyErr_Occurred()) return false;
  PyObject *sixtyfour = PyLong_FromLong(64);
  PyObject *shifted = PyNumber_Rshift(val, sixtyfour);
  Py_DECREF(sixtyfour);
  if (!shifted) return false;
  uint64_t hi = PyLong_AsUnsignedLongLongMask(shifted);
  Py_DECREF(shifted);
  if (hi == (uint64_t)-1 && PyErr_Occurred()) return false;
  out.raw(&lo, 8);
  out.raw(&hi, 8);
  return true;
}

// encode_events(seq of (kind, key, row, time)) -> bytes
// Batched codec.encode_event: one buffer per snapshot chunk, the row
// payload length patched in place — no per-event allocations.  The
// checkpoint writer pool encodes whole raw-event batches here so the
// epoch loop never pays the per-row serializer (input_snapshot.rs
// serialization analog).
static PyObject *py_encode_events(PyObject *, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "encode_events expects a sequence");
  if (!seq) return nullptr;
  Buf out;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *evseq = PySequence_Fast(
        PySequence_Fast_GET_ITEM(seq, i),
        "encode_events: event must be a sequence");
    if (!evseq) {
      Py_DECREF(seq);
      return nullptr;
    }
    bool ok = PySequence_Fast_GET_SIZE(evseq) == 4;
    if (!ok) {
      PyErr_SetString(PyExc_ValueError,
                      "encode_events: expected (kind, key, row, time)");
    } else {
      long kind = PyLong_AsLong(PySequence_Fast_GET_ITEM(evseq, 0));
      ok = !(kind == -1 && PyErr_Occurred());
      if (ok) {
        out.u8((uint8_t)kind);
        if (kind == 1 || kind == 2) {  // EV_INSERT / EV_DELETE
          ok = append_u128_long(out, PySequence_Fast_GET_ITEM(evseq, 1));
          if (ok) {
            size_t len_at = out.d.size();
            out.u64(0);  // payload length, patched below
            size_t start = out.d.size();
            PyObject *rowseq = PySequence_Fast(
                PySequence_Fast_GET_ITEM(evseq, 2),
                "encode_events: row must be a sequence");
            ok = rowseq != nullptr;
            if (ok) {
              Py_ssize_t rn = PySequence_Fast_GET_SIZE(rowseq);
              out.u64((uint64_t)rn);
              for (Py_ssize_t j = 0; ok && j < rn; j++) {
                ok = encode_value(PySequence_Fast_GET_ITEM(rowseq, j), out);
              }
              Py_DECREF(rowseq);
            }
            if (ok) {
              uint64_t plen = (uint64_t)(out.d.size() - start);
              std::memcpy(out.d.data() + len_at, &plen, 8);
            }
          }
        } else if (kind == 3) {  // EV_ADVANCE_TIME
          uint64_t t = PyLong_AsUnsignedLongLongMask(
              PySequence_Fast_GET_ITEM(evseq, 3));
          ok = !(t == (uint64_t)-1 && PyErr_Occurred());
          if (ok) out.u64(t);
        }  // EV_FINISHED and others: kind byte only, like encode_event
      }
    }
    Py_DECREF(evseq);
    if (!ok) {
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  return PyBytes_FromStringAndSize((const char *)out.d.data(), out.d.size());
}

struct Cursor {
  const uint8_t *p;
  size_t len;
  size_t pos;
  bool need(size_t n) {
    // subtraction form: `pos + n` can wrap for corrupted length fields
    if (pos > len || n > len - pos) {
      PyErr_SetString(PyExc_ValueError, "codec: truncated buffer");
      return false;
    }
    return true;
  }
  bool r_u64(uint64_t *v) {
    if (!need(8)) return false;
    std::memcpy(v, p + pos, 8);
    pos += 8;
    return true;
  }
};

static PyObject *decode_value(Cursor &c, PyObject *view);

static PyObject *decode_slow(Cursor &c, PyObject *view, uint8_t tag) {
  // delegate to Python: (tag, view, pos_before_tag_payload) -> (value, new_pos)
  PyObject *res = PyObject_CallFunction(g_decode_slow, "iOn", (int)tag, view,
                                        (Py_ssize_t)c.pos);
  if (!res) return nullptr;
  PyObject *value = PyTuple_GetItem(res, 0);
  PyObject *newpos = PyTuple_GetItem(res, 1);
  if (!value || !newpos) {
    Py_DECREF(res);
    return nullptr;
  }
  c.pos = (size_t)PyLong_AsSsize_t(newpos);
  Py_INCREF(value);
  Py_DECREF(res);
  return value;
}

static PyObject *decode_value(Cursor &c, PyObject *view) {
  if (!c.need(1)) return nullptr;
  uint8_t tag = c.p[c.pos++];
  switch (tag) {
    case T_NONE:
      Py_RETURN_NONE;
    case T_TRUE:
      Py_RETURN_TRUE;
    case T_FALSE:
      Py_RETURN_FALSE;
    case T_INT: {
      if (!c.need(8)) return nullptr;
      int64_t v;
      std::memcpy(&v, c.p + c.pos, 8);
      c.pos += 8;
      return PyLong_FromLongLong(v);
    }
    case T_FLOAT: {
      if (!c.need(8)) return nullptr;
      double v;
      std::memcpy(&v, c.p + c.pos, 8);
      c.pos += 8;
      return PyFloat_FromDouble(v);
    }
    case T_STR: {
      uint64_t n;
      if (!c.r_u64(&n) || !c.need(n)) return nullptr;
      PyObject *s = PyUnicode_DecodeUTF8((const char *)c.p + c.pos, n, nullptr);
      c.pos += n;
      return s;
    }
    case T_BYTES: {
      uint64_t n;
      if (!c.r_u64(&n) || !c.need(n)) return nullptr;
      PyObject *b = PyBytes_FromStringAndSize((const char *)c.p + c.pos, n);
      c.pos += n;
      return b;
    }
    case T_POINTER: {
      if (!c.need(16)) return nullptr;
      uint64_t lo, hi;
      std::memcpy(&lo, c.p + c.pos, 8);
      std::memcpy(&hi, c.p + c.pos + 8, 8);
      c.pos += 16;
      PyObject *plo = PyLong_FromUnsignedLongLong(lo);
      PyObject *phi = PyLong_FromUnsignedLongLong(hi);
      PyObject *sf = PyLong_FromLong(64);
      PyObject *shifted = PyNumber_Lshift(phi, sf);
      PyObject *key = PyNumber_Or(shifted, plo);
      Py_DECREF(plo);
      Py_DECREF(phi);
      Py_DECREF(sf);
      Py_DECREF(shifted);
      if (!key) return nullptr;
      PyObject *ptr = PyObject_CallFunctionObjArgs(g_pointer_cls, key, nullptr);
      Py_DECREF(key);
      return ptr;
    }
    case T_TUPLE: {
      uint64_t n;
      if (!c.r_u64(&n)) return nullptr;
      // every element takes >=1 byte, so a length beyond the remaining
      // buffer is corruption — reject before PyTuple_New sees a bogus
      // (possibly negative-after-cast) size
      if (n > c.len - c.pos) {
        PyErr_SetString(PyExc_ValueError, "codec: corrupt buffer (tuple length)");
        return nullptr;
      }
      PyObject *t = PyTuple_New((Py_ssize_t)n);
      if (!t) return nullptr;
      for (uint64_t i = 0; i < n; i++) {
        PyObject *item = decode_value(c, view);
        if (!item) {
          Py_DECREF(t);
          return nullptr;
        }
        PyTuple_SET_ITEM(t, (Py_ssize_t)i, item);
      }
      return t;
    }
    case T_ERROR:
      Py_INCREF(g_error_obj);
      return g_error_obj;
    default:
      // BIGINT, NDARRAY, JSON, datetimes, DATE, DURATION, PYOBJECT
      return decode_slow(c, view, tag);
  }
}

// decode_row(buffer, pos=0) -> (tuple, new_pos)
static PyObject *py_decode_row(PyObject *, PyObject *args) {
  PyObject *obj;
  Py_ssize_t pos = 0;
  if (!PyArg_ParseTuple(args, "O|n", &obj, &pos)) return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_SIMPLE) < 0) return nullptr;
  PyObject *mview = PyMemoryView_FromBuffer(&view);  // for slow-path calls
  if (!mview) {
    PyBuffer_Release(&view);
    return nullptr;
  }
  Cursor c{(const uint8_t *)view.buf, (size_t)view.len, (size_t)pos};
  uint64_t n = 0;
  PyObject *result = nullptr;
  // each row value takes >=1 byte, so a count beyond the remaining buffer
  // is corruption — reject before PyTuple_New sees a bogus size
  if (c.r_u64(&n) && n <= c.len - c.pos) {
    PyObject *t = PyTuple_New((Py_ssize_t)n);
    if (t) {
      bool ok = true;
      for (uint64_t i = 0; i < n; i++) {
        PyObject *item = decode_value(c, mview);
        if (!item) {
          ok = false;
          break;
        }
        PyTuple_SET_ITEM(t, (Py_ssize_t)i, item);
      }
      if (ok) {
        result = Py_BuildValue("(Nn)", t, (Py_ssize_t)c.pos);
      } else {
        Py_DECREF(t);
      }
    }
  }
  if (!result && !PyErr_Occurred()) {
    PyErr_SetString(PyExc_ValueError, "codec: corrupt buffer (row length)");
  }
  Py_DECREF(mview);
  PyBuffer_Release(&view);
  return result;
}

// ---------------------------------------------------------------------------
// consolidate_dirty: the accumulation half of the engine's per-node delta
// normalization (dataflow.py consolidate).  PRECONDITION: the caller has
// already proven the batch dirty with its (faster, CPython-set) clean scan —
// clean batches must never reach here.  Returns a NEW list of
// (key, row, summed_diff != 0), retractions before insertions in stable
// first-seen order — exactly the Python Counter path's semantics — or
// Py_None when a diff exceeds int64 range (the caller falls back to the
// arbitrary-precision Python path).
// ---------------------------------------------------------------------------

static PyObject *py_consolidate_dirty(PyObject *, PyObject *arg) {
  // private copy: __hash__/__eq__ of engine values run arbitrary Python
  // code that could otherwise mutate the caller's list under our borrowed
  // pointers (the copy holds its own refs to every delta tuple)
  PyObject *seq = PySequence_List(arg);
  if (!seq) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(seq);

  struct Entry {
    PyObject *key;
    PyObject *row;
    long long acc;
  };
  std::vector<Entry> entries;
  entries.reserve(static_cast<size_t>(n));
  std::unordered_map<Py_hash_t, std::vector<size_t>> index;
  index.reserve(static_cast<size_t>(n) * 2 + 8);
  // keeps every PySequence_Fast result alive until the end: for non-tuple
  // deltas the fast object OWNS the key/row items the entries point at
  std::vector<PyObject *> fast_holds;
  fast_holds.reserve(static_cast<size_t>(n));
  auto cleanup = [&]() {
    for (Entry &e : entries) {
      Py_DECREF(e.key);
      Py_DECREF(e.row);
    }
    for (PyObject *f : fast_holds) Py_DECREF(f);
    Py_DECREF(seq);
  };
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PyList_GET_ITEM(seq, i);
    // same contract as the Python `key, row, diff = d` unpack: any
    // 3-element sequence; wrong length -> ValueError
    PyObject *fast = PySequence_Fast(d, "delta must be (key, row, diff)");
    if (!fast) {
      cleanup();
      return nullptr;
    }
    fast_holds.push_back(fast);
    if (PySequence_Fast_GET_SIZE(fast) != 3) {
      cleanup();
      PyErr_SetString(PyExc_ValueError,
                      "delta must have exactly 3 fields (key, row, diff)");
      return nullptr;
    }
    PyObject *key = PySequence_Fast_GET_ITEM(fast, 0);
    PyObject *row = PySequence_Fast_GET_ITEM(fast, 1);
    // own references BEFORE any __hash__/__eq__ runs: even this delta's
    // own key hash may mutate a list-shaped delta and free the borrowed
    // row pointer (a reproduced segfault)
    Py_INCREF(key);
    Py_INCREF(row);
    auto drop_kr = [&]() {
      Py_DECREF(key);
      Py_DECREF(row);
    };
    long long dv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fast, 2));
    if (dv == -1 && PyErr_Occurred()) {
      drop_kr();
      if (PyErr_ExceptionMatches(PyExc_OverflowError)) {
        // beyond int64: let the arbitrary-precision Python path handle it
        PyErr_Clear();
        cleanup();
        Py_RETURN_NONE;
      }
      cleanup();
      return nullptr;
    }
    Py_hash_t hk = PyObject_Hash(key);
    if (hk == -1) {
      drop_kr();
      cleanup();
      return nullptr;
    }
    Py_hash_t hr = PyObject_Hash(row);
    if (hr == -1) {
      drop_kr();
      cleanup();
      return nullptr;
    }
    Py_hash_t combined =
        static_cast<Py_hash_t>(static_cast<uint64_t>(hk) * 1000003ull ^
                               static_cast<uint64_t>(hr));
    auto &bucket = index[combined];
    bool merged = false;
    for (size_t idx : bucket) {
      Entry &e = entries[idx];
      int eqk = PyObject_RichCompareBool(e.key, key, Py_EQ);
      if (eqk < 0) {
        drop_kr();
        cleanup();
        return nullptr;
      }
      if (!eqk) continue;
      int eqr = PyObject_RichCompareBool(e.row, row, Py_EQ);
      if (eqr < 0) {
        drop_kr();
        cleanup();
        return nullptr;
      }
      if (eqr) {
        long long sum;
        if (__builtin_add_overflow(e.acc, dv, &sum)) {
          drop_kr();
          cleanup();
          Py_RETURN_NONE;  // int64 overflow: Python fallback
        }
        e.acc = sum;
        merged = true;
        break;
      }
    }
    if (merged) {
      drop_kr();
    } else {
      bucket.push_back(entries.size());
      entries.push_back(Entry{key, row, dv});  // refs owned above
    }
  }
  PyObject *out = PyList_New(0);
  if (!out) {
    cleanup();
    return nullptr;
  }
  for (int pass = 0; pass < 2; pass++) {
    for (const Entry &e : entries) {
      if (e.acc == 0) continue;
      // pass 0 emits retractions (acc < 0), pass 1 the insertions
      if ((e.acc > 0) == (pass == 0)) continue;
      PyObject *diff = PyLong_FromLongLong(e.acc);
      if (!diff) {
        Py_DECREF(out);
        cleanup();
        return nullptr;
      }
      PyObject *t = PyTuple_Pack(3, e.key, e.row, diff);
      Py_DECREF(diff);
      if (!t || PyList_Append(out, t) < 0) {
        Py_XDECREF(t);
        Py_DECREF(out);
        cleanup();
        return nullptr;
      }
      Py_DECREF(t);
    }
  }
  cleanup();
  return out;
}

// ---------------------------------------------------------------------------
// setup & module def
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// upsert_chain: the per-row half of InputNode.emit_time's upsert session
// (dataflow.py).  For each (key, row, diff): retract the key's previous
// value — this epoch's staged overlay first, then committed state — and
// (diff > 0) insert the new row.  Keys are engine 128-bit ints (PyLong),
// so the dict lookups cannot re-enter Python.  Returns the new delta list
// (retraction-before-insert per key, in arrival order).
// ---------------------------------------------------------------------------

static PyObject *py_upsert_chain(PyObject *, PyObject *args) {
  PyObject *deltas, *state;
  if (!PyArg_ParseTuple(args, "OO", &deltas, &state)) return nullptr;
  if (!PyDict_Check(state)) {
    PyErr_SetString(PyExc_TypeError, "state must be a dict");
    return nullptr;
  }
  PyObject *seq = PySequence_List(deltas);
  if (!seq) return nullptr;
  PyObject *seen = PyDict_New();
  PyObject *out = PyList_New(0);
  PyObject *one = PyLong_FromLong(1);
  PyObject *neg_one = PyLong_FromLong(-1);
  auto fail = [&]() -> PyObject * {
    Py_XDECREF(seen);
    Py_XDECREF(out);
    Py_XDECREF(one);
    Py_XDECREF(neg_one);
    Py_DECREF(seq);
    return nullptr;
  };
  if (!seen || !out || !one || !neg_one) return fail();
  Py_ssize_t n = PyList_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *fast = PySequence_Fast(PyList_GET_ITEM(seq, i),
                                     "delta must be (key, row, diff)");
    if (!fast) return fail();
    if (PySequence_Fast_GET_SIZE(fast) != 3) {
      Py_DECREF(fast);
      PyErr_SetString(PyExc_ValueError,
                      "delta must have exactly 3 fields (key, row, diff)");
      return fail();
    }
    PyObject *key = PySequence_Fast_GET_ITEM(fast, 0);
    PyObject *row = PySequence_Fast_GET_ITEM(fast, 1);
    long long dv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fast, 2));
    if (dv == -1 && PyErr_Occurred()) {
      Py_DECREF(fast);
      return fail();
    }
    PyObject *prev = PyDict_GetItemWithError(seen, key);  // borrowed
    if (!prev) {
      if (PyErr_Occurred()) {
        Py_DECREF(fast);
        return fail();
      }
      prev = PyDict_GetItemWithError(state, key);  // borrowed
      if (!prev && PyErr_Occurred()) {
        Py_DECREF(fast);
        return fail();
      }
    }
    if (prev && prev != Py_None) {
      PyObject *t = PyTuple_Pack(3, key, prev, neg_one);
      int rc = t ? PyList_Append(out, t) : -1;
      Py_XDECREF(t);
      if (rc < 0) {
        Py_DECREF(fast);
        return fail();
      }
    }
    if (dv > 0) {
      PyObject *t = PyTuple_Pack(3, key, row, one);
      int rc = t ? PyList_Append(out, t) : -1;
      Py_XDECREF(t);
      if (rc < 0 || PyDict_SetItem(seen, key, row) < 0) {
        Py_DECREF(fast);
        return fail();
      }
    } else if (PyDict_SetItem(seen, key, Py_None) < 0) {
      Py_DECREF(fast);
      return fail();
    }
    Py_DECREF(fast);
  }
  Py_DECREF(seen);
  Py_DECREF(one);
  Py_DECREF(neg_one);
  Py_DECREF(seq);
  return out;
}


static PyObject *py_setup(PyObject *, PyObject *args) {
  PyObject *pointer_cls, *json_cls, *pyobj_cls, *ndarray_cls, *error_obj,
      *encode_slow, *decode_slow_fn, *ser_slow;
  if (!PyArg_ParseTuple(args, "OOOOOOOO", &pointer_cls, &json_cls, &pyobj_cls,
                        &ndarray_cls, &error_obj, &encode_slow, &decode_slow_fn,
                        &ser_slow))
    return nullptr;
#define SETG(g, v) \
  Py_XDECREF(g);   \
  Py_INCREF(v);    \
  g = v;
  SETG(g_pointer_cls, pointer_cls);
  SETG(g_json_cls, json_cls);
  SETG(g_pyobj_cls, pyobj_cls);
  SETG(g_ndarray_cls, ndarray_cls);
  SETG(g_error_obj, error_obj);
  SETG(g_encode_slow, encode_slow);
  SETG(g_decode_slow, decode_slow_fn);
  SETG(g_ser_slow, ser_slow);
#undef SETG
  Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// Columnar batch materialization (the §7.3 "columnar batches instead of row
// tuples" hot path).  The Python columnar evaluator's cost at 1M rows was
// dominated by per-column list comprehensions, per-value type() scans and
// tuple rebuilds; these two functions do each in one C pass.  Semantics
// mirror vector_compiler.materialize_columns exactly: uniform EXACT Python
// types per column (bool/int/float/str), int64 range (INT64_MIN rejected —
// negation would wrap), bail -> None so the row interpreter takes over.
// ---------------------------------------------------------------------------

// materialize_delta_columns(deltas | rows, needed: tuple[int], from_deltas)
//   -> dict {idx: ("q"|"d"|"?", bytearray) | ("U", list)} | None (bail)
static PyObject *py_materialize_columns(PyObject *, PyObject *args) {
  PyObject *items, *needed;
  int from_deltas;
  if (!PyArg_ParseTuple(args, "OO!p", &items, &PyTuple_Type, &needed,
                        &from_deltas))
    return nullptr;
  if (!PyList_Check(items)) Py_RETURN_NONE;
  Py_ssize_t n = PyList_GET_SIZE(items);
  if (n == 0) Py_RETURN_NONE;
  Py_ssize_t n_cols = PyTuple_GET_SIZE(needed);

  PyObject *result = PyDict_New();
  if (!result) return nullptr;

  for (Py_ssize_t c = 0; c < n_cols; c++) {
    PyObject *idx_obj = PyTuple_GET_ITEM(needed, c);
    Py_ssize_t idx = PyLong_AsSsize_t(idx_obj);
    if (idx < 0 && PyErr_Occurred()) {
      Py_DECREF(result);
      return nullptr;
    }
    // pick the column kind from the first row
    PyObject *first = PyList_GET_ITEM(items, 0);
    if (from_deltas) {
      if (!PyTuple_Check(first) || PyTuple_GET_SIZE(first) != 3) goto bail;
      first = PyTuple_GET_ITEM(first, 1);
    }
    if (!PyTuple_Check(first) || idx >= PyTuple_GET_SIZE(first)) goto bail;
    {
      PyObject *v0 = PyTuple_GET_ITEM(first, idx);
      char kind;
      if (PyBool_Check(v0)) kind = '?';
      else if (PyLong_CheckExact(v0)) kind = 'q';
      else if (PyFloat_CheckExact(v0)) kind = 'd';
      else if (PyUnicode_CheckExact(v0)) kind = 'U';
      else goto bail;

      if (kind == 'U') {
        PyObject *lst = PyList_New(n);
        if (!lst) goto err;
        for (Py_ssize_t i = 0; i < n; i++) {
          PyObject *row = PyList_GET_ITEM(items, i);
          if (from_deltas) {
            // every element must be shape-checked, not just the first —
            // GET_ITEM on a short tuple is out-of-bounds, not an error
            if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) != 3) {
              Py_DECREF(lst);
              goto bail;
            }
            row = PyTuple_GET_ITEM(row, 1);
          }
          if (!PyTuple_Check(row) || idx >= PyTuple_GET_SIZE(row)) {
            Py_DECREF(lst);
            goto bail;
          }
          PyObject *v = PyTuple_GET_ITEM(row, idx);
          if (!PyUnicode_CheckExact(v)) {
            Py_DECREF(lst);
            goto bail;
          }
          Py_INCREF(v);
          PyList_SET_ITEM(lst, i, v);
        }
        PyObject *entry = Py_BuildValue("(sN)", "U", lst);
        if (!entry || PyDict_SetItem(result, idx_obj, entry) != 0) {
          Py_XDECREF(entry);
          goto err;
        }
        Py_DECREF(entry);
        continue;
      }

      Py_ssize_t itemsize = kind == '?' ? 1 : 8;
      PyObject *buf = PyByteArray_FromStringAndSize(nullptr, n * itemsize);
      if (!buf) goto err;
      char *data = PyByteArray_AS_STRING(buf);
      bool ok = true;
      int64_t min_seen = 0;
      for (Py_ssize_t i = 0; i < n && ok; i++) {
        PyObject *row = PyList_GET_ITEM(items, i);
        if (from_deltas) {
          if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) != 3) { ok = false; break; }
          row = PyTuple_GET_ITEM(row, 1);
        }
        if (!PyTuple_Check(row) || idx >= PyTuple_GET_SIZE(row)) { ok = false; break; }
        PyObject *v = PyTuple_GET_ITEM(row, idx);
        switch (kind) {
          case '?':
            if (!PyBool_Check(v)) { ok = false; break; }
            data[i] = (v == Py_True) ? 1 : 0;
            break;
          case 'q': {
            if (!PyLong_CheckExact(v)) { ok = false; break; }
            int overflow = 0;
            long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
            if (overflow != 0) { ok = false; break; }
            if (x < min_seen) min_seen = x;
            ((int64_t *)data)[i] = (int64_t)x;
            break;
          }
          case 'd':
            if (!PyFloat_CheckExact(v)) { ok = false; break; }
            ((double *)data)[i] = PyFloat_AS_DOUBLE(v);
            break;
        }
      }
      if (!ok || (kind == 'q' && min_seen == INT64_MIN)) {
        Py_DECREF(buf);
        goto bail;
      }
      char kind_str[2] = {kind, 0};
      PyObject *entry = Py_BuildValue("(sN)", kind_str, buf);
      if (!entry || PyDict_SetItem(result, idx_obj, entry) != 0) {
        Py_XDECREF(entry);
        goto err;
      }
      Py_DECREF(entry);
    }
  }
  return result;
bail:
  Py_DECREF(result);
  Py_RETURN_NONE;
err:
  Py_DECREF(result);
  return nullptr;
}

// group_indices(values: list) -> (uniques list, int64 inverse bytearray)
// Hash-grouping replacement for np.unique(return_inverse=True) on object
// columns: one pass, no sort, insertion-ordered uniques.  Used by the
// groupby columnar path for string/object group keys where building a
// numpy U-array then sorting it dominated the epoch.
static PyObject *py_group_indices(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "group_indices expects a list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *uniques = PyList_New(0);
  PyObject *index = PyDict_New();  // value -> PyLong position
  PyObject *inv = PyByteArray_FromStringAndSize(nullptr, n * 8);
  if (!uniques || !index || !inv) {
    Py_XDECREF(uniques);
    Py_XDECREF(index);
    Py_XDECREF(inv);
    return nullptr;
  }
  int64_t *out = (int64_t *)PyByteArray_AS_STRING(inv);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *v = PyList_GET_ITEM(arg, i);
    PyObject *pos = PyDict_GetItemWithError(index, v);  // borrowed
    if (!pos) {
      if (PyErr_Occurred()) goto fail;  // unhashable etc.
      pos = PyLong_FromSsize_t(PyList_GET_SIZE(uniques));
      if (!pos || PyDict_SetItem(index, v, pos) != 0 ||
          PyList_Append(uniques, v) != 0) {
        Py_XDECREF(pos);
        goto fail;
      }
      out[i] = PyList_GET_SIZE(uniques) - 1;
      Py_DECREF(pos);
      continue;
    }
    out[i] = PyLong_AsSsize_t(pos);
  }
  Py_DECREF(index);
  return Py_BuildValue("(NN)", uniques, inv);
fail:
  Py_DECREF(uniques);
  Py_DECREF(index);
  Py_DECREF(inv);
  return nullptr;
}

// delta_diffs(deltas) -> int64 bytearray of the diff field, or None when a
// diff exceeds int64 (callers fall back to the Python listcomp)
static PyObject *py_delta_diffs(PyObject *, PyObject *arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "delta_diffs expects a list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *buf = PyByteArray_FromStringAndSize(nullptr, n * 8);
  if (!buf) return nullptr;
  int64_t *out = (int64_t *)PyByteArray_AS_STRING(buf);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *t = PyList_GET_ITEM(arg, i);
    if (!PyTuple_Check(t) || PyTuple_GET_SIZE(t) != 3) {
      Py_DECREF(buf);
      PyErr_SetString(PyExc_ValueError, "delta_diffs: triples expected");
      return nullptr;
    }
    PyObject *d = PyTuple_GET_ITEM(t, 2);
    int overflow = 0;
    long long x = PyLong_AsLongLongAndOverflow(d, &overflow);
    if (overflow != 0 || (x == -1 && PyErr_Occurred())) {
      PyErr_Clear();
      Py_DECREF(buf);
      Py_RETURN_NONE;
    }
    out[i] = (int64_t)x;
  }
  return buf;
}

// stage_static(rows: list[(key, row, time, diff)], list_cls) ->
//   list[(time, deltas_list, clean_bool)] — one pass partitioning build-time
// rows by timestamp, proving per-bucket cleanliness (all diffs == 1, keys
// unique) so the emit path can skip its consolidate scan entirely.
// Clean buckets are built as instances of ``list_cls`` (the engine's
// CleanDeltas list subclass) directly — no tag-copy afterwards.
static PyObject *py_stage_static(PyObject *, PyObject *args) {
  PyObject *arg, *list_cls;
  if (!PyArg_ParseTuple(args, "OO", &arg, &list_cls)) return nullptr;
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "stage_static expects a list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  PyObject *buckets = PyDict_New();   // time -> [deltas, key_set, clean]
  PyObject *order = PyList_New(0);    // first-seen time order
  if (!buckets || !order) {
    Py_XDECREF(buckets);
    Py_XDECREF(order);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *quad = PyList_GET_ITEM(arg, i);
    if (!PyTuple_Check(quad) || PyTuple_GET_SIZE(quad) != 4) {
      PyErr_SetString(PyExc_ValueError, "stage_static: rows must be quads");
      goto fail;
    }
    {
      PyObject *key = PyTuple_GET_ITEM(quad, 0);
      PyObject *row = PyTuple_GET_ITEM(quad, 1);
      PyObject *time = PyTuple_GET_ITEM(quad, 2);
      PyObject *diff = PyTuple_GET_ITEM(quad, 3);
      PyObject *bucket = PyDict_GetItem(buckets, time);  // borrowed
      if (!bucket) {
        // deltas list built as list_cls (CleanDeltas) up front; dirty
        // buckets are downgraded to plain lists at assembly time
        PyObject *deltas_new = PyObject_CallNoArgs(list_cls);
        if (!deltas_new || !PyList_Check(deltas_new)) {
          Py_XDECREF(deltas_new);
          if (!PyErr_Occurred())
            PyErr_SetString(PyExc_TypeError,
                            "stage_static: list_cls must make lists");
          goto fail;
        }
        bucket = Py_BuildValue("[N,N,O]", deltas_new, PySet_New(nullptr),
                               Py_True);
        if (!bucket || PyDict_SetItem(buckets, time, bucket) != 0) {
          Py_XDECREF(bucket);
          goto fail;
        }
        Py_DECREF(bucket);  // dict holds it
        if (PyList_Append(order, time) != 0) goto fail;
        bucket = PyDict_GetItem(buckets, time);
      }
      PyObject *deltas = PyList_GET_ITEM(bucket, 0);
      PyObject *keyset = PyList_GET_ITEM(bucket, 1);
      PyObject *clean = PyList_GET_ITEM(bucket, 2);
      if (clean == Py_True) {
        int is_one = 0;
        if (PyLong_Check(diff)) {
          long d = PyLong_AsLong(diff);
          if (d == -1 && PyErr_Occurred())
            PyErr_Clear();  // out-of-range diff: simply not clean
          else
            is_one = (d == 1);
        }
        int dup = is_one ? PySet_Contains(keyset, key) : 0;
        if (dup < 0) goto fail;
        if (!is_one || dup) {
          PyList_SET_ITEM(bucket, 2, Py_False);
          Py_INCREF(Py_False);
          Py_DECREF(clean);
        } else if (PySet_Add(keyset, key) != 0) {
          goto fail;
        }
      }
      PyObject *triple = PyTuple_Pack(3, key, row, diff);
      if (!triple) goto fail;
      if (PyList_Append(deltas, triple) != 0) {
        Py_DECREF(triple);
        goto fail;
      }
      Py_DECREF(triple);
    }
  }
  {
    Py_ssize_t n_times = PyList_GET_SIZE(order);
    PyObject *out = PyList_New(n_times);
    if (!out) goto fail;
    for (Py_ssize_t i = 0; i < n_times; i++) {
      PyObject *time = PyList_GET_ITEM(order, i);
      PyObject *bucket = PyDict_GetItem(buckets, time);
      PyObject *deltas = PyList_GET_ITEM(bucket, 0);
      PyObject *clean = PyList_GET_ITEM(bucket, 2);
      PyObject *entry;
      if (clean == Py_True) {
        entry = PyTuple_Pack(3, time, deltas, clean);
      } else {
        // downgrade: a CleanDeltas instance must not carry dirty rows
        PyObject *plain = PyList_GetSlice(deltas, 0, PyList_GET_SIZE(deltas));
        if (!plain) {
          Py_DECREF(out);
          goto fail;
        }
        entry = PyTuple_Pack(3, time, plain, clean);
        Py_DECREF(plain);
      }
      if (!entry) {
        Py_DECREF(out);
        goto fail;
      }
      PyList_SET_ITEM(out, i, entry);
    }
    Py_DECREF(buckets);
    Py_DECREF(order);
    return out;
  }
fail:
  Py_DECREF(buckets);
  Py_DECREF(order);
  return nullptr;
}

// filter_deltas(deltas, mask buffer (uint8), n_cols) -> kept deltas with
// rows truncated to n_cols (the filter drops helper columns)
static PyObject *py_filter_deltas(PyObject *, PyObject *args) {
  PyObject *deltas, *mask_obj;
  Py_ssize_t n_cols;
  if (!PyArg_ParseTuple(args, "O!On", &PyList_Type, &deltas, &mask_obj,
                        &n_cols))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  Py_buffer mask;
  if (PyObject_GetBuffer(mask_obj, &mask, PyBUF_CONTIG_RO) != 0)
    return nullptr;
  if (mask.len != n) {
    PyBuffer_Release(&mask);
    PyErr_SetString(PyExc_ValueError, "filter: mask length mismatch");
    return nullptr;
  }
  const char *m = (const char *)mask.buf;
  PyObject *out = PyList_New(0);
  if (!out) {
    PyBuffer_Release(&mask);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    if (!m[i]) continue;
    PyObject *src = PyList_GET_ITEM(deltas, i);
    if (!PyTuple_Check(src) || PyTuple_GET_SIZE(src) != 3) {
      PyErr_SetString(PyExc_ValueError, "filter: deltas must be triples");
      goto fail;
    }
    {
      PyObject *row = PyTuple_GET_ITEM(src, 1);
      if (!PyTuple_Check(row) || PyTuple_GET_SIZE(row) < n_cols) {
        PyErr_SetString(PyExc_ValueError, "filter: short row");
        goto fail;
      }
      PyObject *item = src;
      if (PyTuple_GET_SIZE(row) != n_cols) {
        PyObject *cut = PyTuple_GetSlice(row, 0, n_cols);
        if (!cut) goto fail;
        item = PyTuple_Pack(3, PyTuple_GET_ITEM(src, 0), cut,
                            PyTuple_GET_ITEM(src, 2));
        Py_DECREF(cut);
        if (!item) goto fail;
        if (PyList_Append(out, item) != 0) {
          Py_DECREF(item);
          goto fail;
        }
        Py_DECREF(item);
        continue;
      }
      if (PyList_Append(out, item) != 0) goto fail;
    }
  }
  PyBuffer_Release(&mask);
  return out;
fail:
  Py_DECREF(out);
  PyBuffer_Release(&mask);
  return nullptr;
}

// gather_key_rows(deltas, idxs) -> [tuple(row[i] for i in idxs), ...]
// The multi-column groupby's per-row key-tuple build as one C pass; the
// tuples then hash-group through group_indices (same PyDict semantics as
// the row path's arrangement dict).
static PyObject *py_gather_key_rows(PyObject *, PyObject *args) {
  PyObject *deltas, *idxs;
  if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &deltas, &PyTuple_Type,
                        &idxs))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  Py_ssize_t n_keys = PyTuple_GET_SIZE(idxs);
  std::vector<Py_ssize_t> kidx(n_keys);
  for (Py_ssize_t c = 0; c < n_keys; c++) {
    kidx[c] = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, c));
    if (kidx[c] < 0) {
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "gather: bad key index");
      return nullptr;
    }
  }
  PyObject *out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PyList_GET_ITEM(deltas, i);
    if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
      PyErr_SetString(PyExc_ValueError, "gather: deltas must be triples");
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *row = PyTuple_GET_ITEM(item, 1);
    PyObject *key = PyTuple_New(n_keys);
    if (!key) {
      Py_DECREF(out);
      return nullptr;
    }
    for (Py_ssize_t c = 0; c < n_keys; c++) {
      if (!PyTuple_Check(row) || kidx[c] >= PyTuple_GET_SIZE(row)) {
        PyErr_SetString(PyExc_ValueError, "gather: key index out of range");
        Py_DECREF(key);
        Py_DECREF(out);
        return nullptr;
      }
      PyObject *v = PyTuple_GET_ITEM(row, kidx[c]);
      Py_INCREF(v);
      PyTuple_SET_ITEM(key, c, v);
    }
    PyList_SET_ITEM(out, i, key);
  }
  return out;
}

// split_deltas(deltas, mask) -> (kept, dropped): partition a delta list by
// a uint8 mask without touching rows — the temporal buffers' release scan
// (BufferNode) and freeze/forget admit paths run it once per epoch batch.
static PyObject *py_split_deltas(PyObject *, PyObject *args) {
  PyObject *deltas, *mask_obj;
  if (!PyArg_ParseTuple(args, "O!O", &PyList_Type, &deltas, &mask_obj))
    return nullptr;
  Py_buffer mask;
  if (PyObject_GetBuffer(mask_obj, &mask, PyBUF_CONTIG_RO) != 0)
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  if (mask.len != n) {
    PyBuffer_Release(&mask);
    PyErr_SetString(PyExc_ValueError, "split: mask length mismatch");
    return nullptr;
  }
  const char *m = (const char *)mask.buf;
  PyObject *kept = PyList_New(0);
  PyObject *dropped = PyList_New(0);
  if (!kept || !dropped) {
    Py_XDECREF(kept);
    Py_XDECREF(dropped);
    PyBuffer_Release(&mask);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; i++) {
    if (PyList_Append(m[i] ? kept : dropped, PyList_GET_ITEM(deltas, i)) !=
        0) {
      Py_DECREF(kept);
      Py_DECREF(dropped);
      PyBuffer_Release(&mask);
      return nullptr;
    }
  }
  PyBuffer_Release(&mask);
  return Py_BuildValue("(NN)", kept, dropped);
}

// freeze_scan(kind "q"|"d", t buffer, thr buffer, watermark|None)
//   -> (keep-mask bytearray, new watermark|None)
// FreezeNode's sequential admit/advance scan as one GIL-released pass:
// row i is kept unless thr[i] <= wm; kept rows advance wm to max(wm, t[i])
// *in scan order* (later rows see earlier rows' watermark — the data
// dependence that keeps this out of numpy).
static PyObject *py_freeze_scan(PyObject *, PyObject *args) {
  const char *kind;
  PyObject *t_obj, *thr_obj, *wm_obj;
  if (!PyArg_ParseTuple(args, "sOOO", &kind, &t_obj, &thr_obj, &wm_obj))
    return nullptr;
  Py_buffer t, thr;
  if (PyObject_GetBuffer(t_obj, &t, PyBUF_CONTIG_RO) != 0) return nullptr;
  if (PyObject_GetBuffer(thr_obj, &thr, PyBUF_CONTIG_RO) != 0) {
    PyBuffer_Release(&t);
    return nullptr;
  }
  PyObject *result = nullptr;
  Py_ssize_t n = t.len / 8;
  bool is_int = kind[0] == 'q';
  bool has_wm = wm_obj != Py_None;
  int64_t wm_i = 0;
  double wm_d = 0.0;
  bool ok = true;
  if (t.len != thr.len || t.len % 8 != 0) {
    PyErr_SetString(PyExc_ValueError, "freeze_scan: buffer length mismatch");
    ok = false;
  } else if (kind[0] != 'q' && kind[0] != 'd') {
    PyErr_SetString(PyExc_ValueError, "freeze_scan: unknown kind");
    ok = false;
  } else if (has_wm) {
    if (is_int) {
      wm_i = PyLong_AsLongLong(wm_obj);
      if (wm_i == -1 && PyErr_Occurred()) ok = false;
    } else {
      wm_d = PyFloat_AsDouble(wm_obj);
      if (wm_d == -1.0 && PyErr_Occurred()) ok = false;
    }
  }
  PyObject *mask = ok ? PyByteArray_FromStringAndSize(nullptr, n) : nullptr;
  if (ok && mask) {
    char *m = PyByteArray_AS_STRING(mask);
    const int64_t *ti = (const int64_t *)t.buf;
    const int64_t *thi = (const int64_t *)thr.buf;
    const double *td = (const double *)t.buf;
    const double *thd = (const double *)thr.buf;
    Py_BEGIN_ALLOW_THREADS
    if (is_int) {
      for (Py_ssize_t i = 0; i < n; i++) {
        if (has_wm && thi[i] <= wm_i) {
          m[i] = 0;
          continue;
        }
        if (!has_wm || ti[i] > wm_i) {
          wm_i = ti[i];
          has_wm = true;
        }
        m[i] = 1;
      }
    } else {
      for (Py_ssize_t i = 0; i < n; i++) {
        if (has_wm && thd[i] <= wm_d) {
          m[i] = 0;
          continue;
        }
        if (!has_wm || td[i] > wm_d) {
          wm_d = td[i];
          has_wm = true;
        }
        m[i] = 1;
      }
    }
    Py_END_ALLOW_THREADS
    PyObject *wm_out;
    if (!has_wm) {
      wm_out = Py_None;
      Py_INCREF(wm_out);
    } else if (is_int) {
      wm_out = PyLong_FromLongLong(wm_i);
    } else {
      wm_out = PyFloat_FromDouble(wm_d);
    }
    if (wm_out) result = Py_BuildValue("(NN)", mask, wm_out);
    if (!result) Py_DECREF(mask);
  } else {
    Py_XDECREF(mask);
  }
  PyBuffer_Release(&t);
  PyBuffer_Release(&thr);
  return result;
}

// route_deltas(deltas, key_idxs, n_dest, hash_none) -> [dest lists]
// The exchange hot loop (engine/comm.py exchange_deltas) batched: per row,
// serialize the routing-key columns exactly as hash_values does, blake2b,
// dest = (low 16 bits) % n_dest — the shard_to_worker rule.  hash_none=0
// (equi-join none_guard semantics): a None/Error key value routes the row
// by its own key; hash_none=1 (groupby keys): Nones hash like any value.
// Any per-row serialization failure routes by row key, mirroring the
// Python loop's per-row exception fallback.
static PyObject *py_route_deltas(PyObject *, PyObject *args) {
  PyObject *deltas, *idxs;
  int n_dest, hash_none;
  if (!PyArg_ParseTuple(args, "O!O!ip", &PyList_Type, &deltas, &PyTuple_Type,
                        &idxs, &n_dest, &hash_none))
    return nullptr;
  if (n_dest <= 0) {
    PyErr_SetString(PyExc_ValueError, "route: n_dest must be positive");
    return nullptr;
  }
  Py_ssize_t n_keys = PyTuple_GET_SIZE(idxs);
  std::vector<Py_ssize_t> kidx(n_keys);
  for (Py_ssize_t c = 0; c < n_keys; c++) {
    kidx[c] = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, c));
    if (kidx[c] < 0) {
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "route: bad key index");
      return nullptr;
    }
  }
  PyObject *out = PyList_New(n_dest);
  if (!out) return nullptr;
  for (int d = 0; d < n_dest; d++) {
    PyObject *lst = PyList_New(0);
    if (!lst) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, d, lst);
  }
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  Buf buf;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *item = PyList_GET_ITEM(deltas, i);
    long dest = -1;
    if (PyTuple_Check(item) && PyTuple_GET_SIZE(item) == 3) {
      PyObject *row = PyTuple_GET_ITEM(item, 1);
      bool by_key = false;
      if (!PyTuple_Check(row)) {
        by_key = true;
      } else {
        for (Py_ssize_t c = 0; c < n_keys && !by_key; c++) {
          if (kidx[c] >= PyTuple_GET_SIZE(row)) {
            by_key = true;
            break;
          }
          PyObject *v = PyTuple_GET_ITEM(row, kidx[c]);
          if (!hash_none && (v == Py_None || v == g_error_obj)) by_key = true;
        }
      }
      if (!by_key) {
        buf.d.clear();
        for (Py_ssize_t c = 0; c < n_keys && !by_key; c++) {
          if (!ser_value(PyTuple_GET_ITEM(row, kidx[c]), buf)) {
            PyErr_Clear();  // per-row fallback, like the Python loop
            by_key = true;
          }
        }
      }
      if (by_key) {
        PyObject *key = PyTuple_GET_ITEM(item, 0);
        uint64_t lo = PyLong_AsUnsignedLongLongMask(key);
        if (lo == (uint64_t)-1 && PyErr_Occurred()) {
          Py_DECREF(out);
          return nullptr;  // a non-int row key crashes the Python loop too
        }
        dest = (long)((lo & 0xFFFFu) % (uint64_t)n_dest);
      } else {
        uint8_t digest[16];
        blake2b_hash(digest, 16, buf.d.data(), buf.d.size());
        uint64_t lo;
        std::memcpy(&lo, digest, 8);
        dest = (long)((lo & 0xFFFFu) % (uint64_t)n_dest);
      }
    } else {
      PyErr_SetString(PyExc_ValueError, "route: deltas must be triples");
      Py_DECREF(out);
      return nullptr;
    }
    if (PyList_Append(PyList_GET_ITEM(out, dest), item) != 0) {
      Py_DECREF(out);
      return nullptr;
    }
  }
  return out;
}

// rebuild_delta_rows(deltas, cols) with cols entries:
//   ("q"|"d"|"?", buffer) | ("U", list) | ("P", source column index) —
//   "P" copies the value straight from the input row (passthrough)
//   -> new list of (key, tuple(values...), diff) with keys/diffs reused
static PyObject *py_rebuild_delta_rows(PyObject *, PyObject *args) {
  PyObject *deltas, *cols;
  if (!PyArg_ParseTuple(args, "O!O!", &PyList_Type, &deltas, &PyList_Type,
                        &cols))
    return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(deltas);
  Py_ssize_t n_cols = PyList_GET_SIZE(cols);

  struct Col {
    char kind;
    const char *data = nullptr;
    PyObject *lst = nullptr;
    Py_ssize_t src_idx = -1;
    Py_buffer view{};
    bool has_view = false;
  };
  std::vector<Col> parsed(n_cols);
  bool fail = false;
  for (Py_ssize_t c = 0; c < n_cols && !fail; c++) {
    PyObject *entry = PyList_GET_ITEM(cols, c);
    const char *kind_s;
    PyObject *payload;
    if (!PyArg_ParseTuple(entry, "sO", &kind_s, &payload)) { fail = true; break; }
    parsed[c].kind = kind_s[0];
    if (parsed[c].kind == 'P') {
      parsed[c].src_idx = PyLong_AsSsize_t(payload);
      if (parsed[c].src_idx < 0) {
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_ValueError, "rebuild: bad passthrough index");
        fail = true;
      }
    } else if (parsed[c].kind == 'U') {
      if (!PyList_Check(payload) || PyList_GET_SIZE(payload) != n) {
        PyErr_SetString(PyExc_ValueError, "rebuild: U column length mismatch");
        fail = true; break;
      }
      parsed[c].lst = payload;
    } else {
      if (PyObject_GetBuffer(payload, &parsed[c].view, PyBUF_CONTIG_RO) != 0) {
        fail = true; break;
      }
      parsed[c].has_view = true;
      Py_ssize_t itemsize = parsed[c].kind == '?' ? 1 : 8;
      if (parsed[c].view.len != n * itemsize) {
        PyErr_SetString(PyExc_ValueError, "rebuild: column length mismatch");
        fail = true; break;
      }
      parsed[c].data = (const char *)parsed[c].view.buf;
    }
  }
  PyObject *out = nullptr;
  if (!fail) {
    out = PyList_New(n);
    for (Py_ssize_t i = 0; i < n && out; i++) {
      PyObject *src = PyList_GET_ITEM(deltas, i);
      if (!PyTuple_Check(src) || PyTuple_GET_SIZE(src) != 3) {
        PyErr_SetString(PyExc_ValueError, "rebuild: deltas must be triples");
        Py_CLEAR(out);
        break;
      }
      PyObject *row = PyTuple_New(n_cols);
      if (!row) { Py_CLEAR(out); break; }
      for (Py_ssize_t c = 0; c < n_cols; c++) {
        PyObject *v = nullptr;
        switch (parsed[c].kind) {
          case 'q':
            v = PyLong_FromLongLong(((const int64_t *)parsed[c].data)[i]);
            break;
          case 'd':
            v = PyFloat_FromDouble(((const double *)parsed[c].data)[i]);
            break;
          case '?':
            v = PyBool_FromLong(parsed[c].data[i]);
            break;
          case 'U':
            v = PyList_GET_ITEM(parsed[c].lst, i);
            Py_INCREF(v);
            break;
          case 'P': {
            PyObject *srow = PyTuple_GET_ITEM(src, 1);
            if (!PyTuple_Check(srow) ||
                parsed[c].src_idx >= PyTuple_GET_SIZE(srow)) {
              PyErr_SetString(PyExc_ValueError,
                              "rebuild: passthrough index out of range");
              break;
            }
            v = PyTuple_GET_ITEM(srow, parsed[c].src_idx);
            Py_INCREF(v);
            break;
          }
          default:
            PyErr_SetString(PyExc_ValueError, "rebuild: unknown column kind");
        }
        if (!v) { Py_DECREF(row); Py_CLEAR(out); break; }
        PyTuple_SET_ITEM(row, c, v);
      }
      if (!out) break;
      PyObject *key = PyTuple_GET_ITEM(src, 0);
      PyObject *diff = PyTuple_GET_ITEM(src, 2);
      PyObject *triple = PyTuple_Pack(3, key, row, diff);
      Py_DECREF(row);
      if (!triple) { Py_CLEAR(out); break; }
      PyList_SET_ITEM(out, i, triple);
    }
  }
  for (auto &col : parsed)
    if (col.has_view) PyBuffer_Release(&col.view);
  return out;
}

// ---------------------------------------------------------------------------
// HNSW approximate-nearest-neighbor core (Malkov & Yashunin 2016).
//
// Parity role: the reference links the USearch C library for its HNSW
// external index (src/external_integration/usearch_integration.rs:163); this
// is the equivalent native core.  The Python layer
// (stdlib/indexing/hnsw.py) keeps key mapping, metadata filters and
// tombstone-compaction policy; this core owns the graph, the vector store
// and the hot search/insert loops over dense u32 node ids.
// ---------------------------------------------------------------------------

#include <cmath>
#include <queue>
#include <random>
#include <algorithm>

namespace hnsw {

struct Index {
  int dim;
  int metric;  // 0 = dot-based (cos/ip; cos pre-normalized on add), 1 = l2sq
  int m, m0, ef_construction;
  bool normalize;
  double ml;
  std::mt19937_64 rng;
  std::vector<float> vecs;                               // node * dim
  std::vector<int> levels;                               // per node
  std::vector<char> dead;                                // tombstones
  std::vector<std::vector<std::vector<uint32_t>>> links; // [layer][node]
  int64_t entry = -1;
  size_t n_dead = 0;
  // visited-set epoch marking: O(1) reset per search
  std::vector<uint32_t> visit_mark;
  uint32_t visit_epoch = 0;

  size_t size() const { return levels.size(); }

  const float *vec(uint32_t id) const { return vecs.data() + (size_t)id * dim; }

  float dist(const float *a, const float *b) const {
    float acc = 0.f;
    if (metric == 1) {
      for (int i = 0; i < dim; i++) {
        float d = a[i] - b[i];
        acc += d * d;
      }
      return acc;
    }
    for (int i = 0; i < dim; i++) acc += a[i] * b[i];
    return -acc;  // similarity -> distance
  }

  int draw_level() {
    double u = std::uniform_real_distribution<double>(1e-12, 1.0)(rng);
    return (int)(-std::log(u) * ml);
  }

  uint32_t greedy(const float *q, uint32_t start, int layer) const {
    uint32_t cur = start;
    float cur_d = dist(q, vec(cur));
    bool improved = true;
    while (improved) {
      improved = false;
      for (uint32_t nb : links[layer][cur]) {
        float d = dist(q, vec(nb));
        if (d < cur_d) {
          cur_d = d;
          cur = nb;
          improved = true;
        }
      }
    }
    return cur;
  }

  // beam search on a layer; results (dist, id) sorted ascending, may
  // include tombstoned nodes (callers filter)
  void search_layer(const float *q, uint32_t ep, int layer, int ef,
                    std::vector<std::pair<float, uint32_t>> &out) {
    if (++visit_epoch == 0) {  // u32 wrap: clear marks once per 4G searches
      std::fill(visit_mark.begin(), visit_mark.end(), 0);
      visit_epoch = 1;
    }
    visit_mark.resize(size(), 0);
    using Entry = std::pair<float, uint32_t>;
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> cand;
    std::priority_queue<Entry> best;  // max-heap
    float d0 = dist(q, vec(ep));
    cand.push({d0, ep});
    best.push({d0, ep});
    visit_mark[ep] = visit_epoch;
    while (!cand.empty()) {
      auto [d, id] = cand.top();
      if ((int)best.size() >= ef && d > best.top().first) break;
      cand.pop();
      for (uint32_t nb : links[layer][id]) {
        if (visit_mark[nb] == visit_epoch) continue;
        visit_mark[nb] = visit_epoch;
        float nd = dist(q, vec(nb));
        if ((int)best.size() < ef || nd < best.top().first) {
          cand.push({nd, nb});
          best.push({nd, nb});
          if ((int)best.size() > ef) best.pop();
        }
      }
    }
    out.resize(best.size());
    for (size_t i = best.size(); i-- > 0;) {
      out[i] = best.top();
      best.pop();
    }
  }

  int64_t add(const float *raw) {
    uint32_t id = (uint32_t)size();
    vecs.insert(vecs.end(), raw, raw + dim);
    if (normalize) {
      float *v = vecs.data() + (size_t)id * dim;
      float n = 0.f;
      for (int i = 0; i < dim; i++) n += v[i] * v[i];
      if (n > 0.f) {
        n = 1.0f / std::sqrt(n);
        for (int i = 0; i < dim; i++) v[i] *= n;
      }
    }
    int level = draw_level();
    levels.push_back(level);
    dead.push_back(0);
    while ((int)links.size() <= level) links.emplace_back();
    for (auto &layer : links) layer.resize(size());

    if (entry < 0 || dead[entry]) {
      entry = id;
      return id;
    }
    const float *q = vec(id);
    uint32_t ep = (uint32_t)entry;
    int top = levels[entry];
    for (int layer = top; layer > level; layer--) ep = greedy(q, ep, layer);
    std::vector<std::pair<float, uint32_t>> cands;
    for (int layer = std::min(level, top); layer >= 0; layer--) {
      search_layer(q, ep, layer, ef_construction, cands);
      int m_max = layer == 0 ? m0 : m;
      auto &mine = links[layer][id];
      mine.clear();
      for (auto &[d, k] : cands) {
        if (k == id) continue;
        mine.push_back(k);
        if ((int)mine.size() >= m) break;
      }
      for (uint32_t nb : mine) {
        auto &lst = links[layer][nb];
        lst.push_back(id);
        if ((int)lst.size() > m_max) {
          // prune: keep the m_max closest to nb
          const float *nv = vec(nb);
          std::vector<std::pair<float, uint32_t>> scored;
          scored.reserve(lst.size());
          for (uint32_t t : lst) scored.push_back({dist(nv, vec(t)), t});
          std::nth_element(scored.begin(), scored.begin() + m_max,
                           scored.end());
          lst.clear();
          for (int i = 0; i < m_max; i++) lst.push_back(scored[i].second);
        }
      }
      if (!cands.empty()) ep = cands[0].second;
    }
    if (level > levels[entry]) entry = id;
    return id;
  }

  void remove(uint32_t id) {
    if (id >= size() || dead[id]) return;
    dead[id] = 1;
    n_dead++;
    if ((int64_t)id == entry) {
      entry = -1;
      int best_level = -1;
      for (size_t i = 0; i < size(); i++)
        if (!dead[i] && levels[i] > best_level) {
          best_level = levels[i];
          entry = (int64_t)i;
        }
    }
  }

  void search(const float *raw_q, int k, int ef,
              std::vector<std::pair<float, uint32_t>> &out) {
    out.clear();
    if (entry < 0) return;
    std::vector<float> qbuf(raw_q, raw_q + dim);
    if (normalize) {
      float n = 0.f;
      for (int i = 0; i < dim; i++) n += qbuf[i] * qbuf[i];
      if (n > 0.f) {
        n = 1.0f / std::sqrt(n);
        for (int i = 0; i < dim; i++) qbuf[i] *= n;
      }
    }
    const float *q = qbuf.data();
    if (ef < k) ef = k;
    uint32_t ep = (uint32_t)entry;
    for (int layer = levels[entry]; layer > 0; layer--) ep = greedy(q, ep, layer);
    std::vector<std::pair<float, uint32_t>> found;
    search_layer(q, ep, 0, ef, found);
    for (auto &e : found)
      if (!dead[e.second]) out.push_back(e);
  }
};

}  // namespace hnsw

static void hnsw_capsule_free(PyObject *cap) {
  delete (hnsw::Index *)PyCapsule_GetPointer(cap, "pathway_tpu_torch.hnsw");
}

static hnsw::Index *hnsw_from(PyObject *cap) {
  return (hnsw::Index *)PyCapsule_GetPointer(cap, "pathway_tpu_torch.hnsw");
}

static PyObject *py_hnsw_new(PyObject *, PyObject *args) {
  int dim, m, efc;
  unsigned long long seed;
  const char *metric;
  if (!PyArg_ParseTuple(args, "isiiK", &dim, &metric, &m, &efc, &seed))
    return nullptr;
  auto *ix = new hnsw::Index();
  ix->dim = dim;
  std::string ms(metric);
  ix->metric = ms == "l2sq" ? 1 : 0;
  ix->normalize = ms == "cos";
  ix->m = m < 2 ? 2 : m;
  ix->m0 = 2 * ix->m;
  ix->ef_construction = efc < ix->m ? ix->m : efc;
  ix->ml = 1.0 / std::log((double)ix->m);
  ix->rng.seed(seed);
  return PyCapsule_New(ix, "pathway_tpu_torch.hnsw", hnsw_capsule_free);
}

static int hnsw_get_floats(PyObject *obj, int dim, Py_buffer *view) {
  if (PyObject_GetBuffer(obj, view, PyBUF_CONTIG_RO) != 0) return -1;
  if (view->len != (Py_ssize_t)(dim * sizeof(float))) {
    PyBuffer_Release(view);
    PyErr_Format(PyExc_ValueError, "expected %d float32 values", dim);
    return -1;
  }
  return 0;
}

static PyObject *py_hnsw_add(PyObject *, PyObject *args) {
  PyObject *cap, *buf;
  if (!PyArg_ParseTuple(args, "OO", &cap, &buf)) return nullptr;
  auto *ix = hnsw_from(cap);
  if (!ix) return nullptr;
  Py_buffer view;
  if (hnsw_get_floats(buf, ix->dim, &view) != 0) return nullptr;
  int64_t id = ix->add((const float *)view.buf);
  PyBuffer_Release(&view);
  return PyLong_FromLongLong(id);
}

static PyObject *py_hnsw_remove(PyObject *, PyObject *args) {
  PyObject *cap;
  unsigned long id;
  if (!PyArg_ParseTuple(args, "Ok", &cap, &id)) return nullptr;
  auto *ix = hnsw_from(cap);
  if (!ix) return nullptr;
  ix->remove((uint32_t)id);
  Py_RETURN_NONE;
}

static PyObject *py_hnsw_search(PyObject *, PyObject *args) {
  PyObject *cap, *buf;
  int k, ef;
  if (!PyArg_ParseTuple(args, "OOii", &cap, &buf, &k, &ef)) return nullptr;
  auto *ix = hnsw_from(cap);
  if (!ix) return nullptr;
  Py_buffer view;
  if (hnsw_get_floats(buf, ix->dim, &view) != 0) return nullptr;
  std::vector<std::pair<float, uint32_t>> out;
  ix->search((const float *)view.buf, k, ef, out);
  PyBuffer_Release(&view);
  PyObject *res = PyList_New((Py_ssize_t)out.size());
  if (!res) return nullptr;
  for (size_t i = 0; i < out.size(); i++) {
    PyObject *pair =
        Py_BuildValue("(kf)", (unsigned long)out[i].second, out[i].first);
    if (!pair) {
      Py_DECREF(res);
      return nullptr;
    }
    PyList_SET_ITEM(res, (Py_ssize_t)i, pair);
  }
  return res;
}

static PyObject *py_hnsw_get_vector(PyObject *, PyObject *args) {
  PyObject *cap;
  unsigned long id;
  if (!PyArg_ParseTuple(args, "Ok", &cap, &id)) return nullptr;
  auto *ix = hnsw_from(cap);
  if (!ix) return nullptr;
  if (id >= ix->size()) {
    PyErr_SetString(PyExc_KeyError, "unknown hnsw node id");
    return nullptr;
  }
  // prepped form (cos: normalized) — re-adding it is idempotent
  return PyBytes_FromStringAndSize((const char *)ix->vec((uint32_t)id),
                                   (Py_ssize_t)ix->dim * sizeof(float));
}

static PyObject *py_hnsw_stats(PyObject *, PyObject *arg) {
  auto *ix = hnsw_from(arg);
  if (!ix) return nullptr;
  return Py_BuildValue("(kk)", (unsigned long)ix->size(),
                       (unsigned long)ix->n_dead);
}

// ---------------------------------------------------------------------------
// Native inner equi-join (reference hot path: src/engine/dataflow.rs:2740).
//
// The Python JoinNode.step costs ~µs/row in closure calls, tuple builds and
// per-pair hash_values round trips.  This C++ index holds both sides keyed
// by the blake2b-128 of the join-key column values (the same 128-bit key
// discipline the whole engine uses) and runs the full delta-join rule
// (dL⋈R then dR⋈L′) in one call per epoch.  Semantics mirror the row path
// exactly: None/Error join keys match nothing and are not stored (SQL null
// semantics); inserts replace, removals drop; emission diff = delta diff.
// ---------------------------------------------------------------------------

namespace joinx {

struct U128 {
  uint64_t lo = 0, hi = 0;
  bool operator==(const U128 &o) const { return lo == o.lo && hi == o.hi; }
};
struct U128H {
  size_t operator()(const U128 &k) const {
    return (size_t)(k.lo ^ (k.hi * 0x9E3779B97F4A7C15ull));
  }
};
struct Entry {
  U128 kh;        // row-key hash (bucket membership)
  PyObject *key;  // owned
  PyObject *row;  // owned
  long long matches = 0;  // outer modes: live matches on the other side
};
// buckets are small vectors, not maps: the common join has a handful of
// rows per key, where a linear scan beats a per-key unordered_map heap
// allocation by ~2x; a heavily skewed bucket degrades removals to O(rows)
using Bucket = std::vector<Entry>;
using Side = std::unordered_map<U128, Bucket, U128H>;  // jk-hash -> rows

struct Index {
  Side sides[2];  // 0 = left, 1 = right
  ~Index() {
    for (auto &side : sides)
      for (auto &b : side)
        for (auto &e : b.second) {
          Py_DECREF(e.key);
          Py_DECREF(e.row);
        }
  }
};

}  // namespace joinx

static void join_capsule_free(PyObject *cap) {
  delete (joinx::Index *)PyCapsule_GetPointer(cap, "pathway_tpu_torch.join");
}

static joinx::Index *join_from(PyObject *cap) {
  return (joinx::Index *)PyCapsule_GetPointer(cap, "pathway_tpu_torch.join");
}

static PyObject *py_join_new(PyObject *, PyObject *) {
  return PyCapsule_New(new joinx::Index(), "pathway_tpu_torch.join",
                       join_capsule_free);
}

// 128-bit <-> PyLong converters.  On CPython <= 3.12 the private-but-
// exported byte-array functions skip all object churn; 3.13 changed
// _PyLong_AsByteArray's signature (added with_exceptions), so any newer
// interpreter takes the portable PyNumber path — slower, never ABI-wrong.
#if PY_VERSION_HEX < 0x030D0000
#define PW_HAVE_LONG_BYTEARRAY 1
extern "C" {
PyObject *_PyLong_FromByteArray(const unsigned char *bytes, size_t n,
                                int little_endian, int is_signed);
int _PyLong_AsByteArray(PyLongObject *v, unsigned char *bytes, size_t n,
                        int little_endian, int is_signed);
}
#else
#define PW_HAVE_LONG_BYTEARRAY 0
#endif

static PyObject *pylong_from_u128(uint64_t lo, uint64_t hi) {
#if PW_HAVE_LONG_BYTEARRAY
  uint8_t bytes[16];
  std::memcpy(bytes, &lo, 8);
  std::memcpy(bytes + 8, &hi, 8);
  return _PyLong_FromByteArray(bytes, 16, 1, 0);
#else
  PyObject *plo = PyLong_FromUnsignedLongLong(lo);
  PyObject *phi = PyLong_FromUnsignedLongLong(hi);
  PyObject *sixtyfour = PyLong_FromLong(64);
  PyObject *shifted = phi ? PyNumber_Lshift(phi, sixtyfour) : nullptr;
  PyObject *res = shifted ? PyNumber_Or(shifted, plo) : nullptr;
  Py_XDECREF(plo);
  Py_XDECREF(phi);
  Py_XDECREF(sixtyfour);
  Py_XDECREF(shifted);
  return res;
#endif
}

// portable 128-bit extraction (mask low 64, shift for high)
static bool u128_of_pylong_slow(PyObject *v, joinx::U128 *out) {
  out->lo = PyLong_AsUnsignedLongLongMask(v);
  if (PyErr_Occurred()) return false;
  PyObject *sixtyfour = PyLong_FromLong(64);
  PyObject *shifted = PyNumber_Rshift(v, sixtyfour);
  Py_DECREF(sixtyfour);
  if (!shifted) return false;
  out->hi = PyLong_AsUnsignedLongLongMask(shifted);
  Py_DECREF(shifted);
  return !PyErr_Occurred();
}

// 128-bit row key from its PyLong
static bool u128_of_pylong(PyObject *v, joinx::U128 *out) {
#if PW_HAVE_LONG_BYTEARRAY
  uint8_t bytes[16];
  if (_PyLong_AsByteArray((PyLongObject *)v, bytes, 16, 1, 0) < 0) {
    // negative or >128-bit keys never occur (KEY_MASK); be exact anyway
    PyErr_Clear();
    return u128_of_pylong_slow(v, out);
  }
  std::memcpy(&out->lo, bytes, 8);
  std::memcpy(&out->hi, bytes + 8, 8);
  return true;
#else
  return u128_of_pylong_slow(v, out);
#endif
}

// join key of a row: blake2b-128 of ser_value over the key columns.
// Returns 1 ok, 0 null-key (None/Error present — matches nothing), -1 error.
// ``buf`` is caller-provided so row loops reuse one allocation.
static int join_key_of(PyObject *row, PyObject *idxs, Buf &buf,
                       joinx::U128 *out) {
  buf.d.clear();
  Py_ssize_t n = PyTuple_GET_SIZE(idxs);
  bool row_is_tuple = PyTuple_Check(row);
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_ssize_t idx = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, i));
    if (idx < 0 && PyErr_Occurred()) return -1;
    PyObject *v;
    if (row_is_tuple) {
      if (idx >= PyTuple_GET_SIZE(row)) {
        PyErr_SetString(PyExc_IndexError, "join key index out of range");
        return -1;
      }
      v = PyTuple_GET_ITEM(row, idx);
    } else {
      v = PySequence_GetItem(row, idx);
      if (!v) return -1;
      Py_DECREF(v);  // row holds a ref; borrow like the tuple path
    }
    if (v == Py_None || Py_TYPE(v) == Py_TYPE(g_error_obj)) return 0;
    if (!ser_value(v, buf)) return -1;
  }
  uint8_t digest[16];
  blake2b_hash(digest, 16, buf.d.data(), buf.d.size());
  std::memcpy(&out->lo, digest, 8);
  std::memcpy(&out->hi, digest + 8, 8);
  return 1;
}

// output row key: mode 0 = hash_values([Pointer(lkey), Pointer(rkey)]),
// mode 1 = lkey (join id'd to the left side), mode 2 = rkey
static PyObject *join_okey(int mode, PyObject *lkey, PyObject *rkey,
                           const joinx::U128 &lk, const joinx::U128 &rk) {
  if (mode == 1) {
    Py_INCREF(lkey);
    return lkey;
  }
  if (mode == 2) {
    Py_INCREF(rkey);
    return rkey;
  }
  // ser(Pointer) is tag 0x06 + 16-byte LE value — build both inline
  uint8_t data[34];
  data[0] = 0x06;
  std::memcpy(data + 1, &lk.lo, 8);
  std::memcpy(data + 9, &lk.hi, 8);
  data[17] = 0x06;
  std::memcpy(data + 18, &rk.lo, 8);
  std::memcpy(data + 26, &rk.hi, 8);
  uint8_t digest[16];
  blake2b_hash(digest, 16, data, 34);
  uint64_t lo, hi;
  std::memcpy(&lo, digest, 8);
  std::memcpy(&hi, digest + 8, 8);
  return pylong_from_u128(lo, hi);
}

// hash_values([Pointer(k), None]) / ([None, Pointer(k)]) for null-padded
// outer rows (ser None = single 0x00 byte)
static PyObject *join_okey_null(bool left_null, const joinx::U128 &k) {
  uint8_t buf[18];
  if (left_null) {
    buf[0] = 0x00;
    buf[1] = 0x06;
    std::memcpy(buf + 2, &k.lo, 8);
    std::memcpy(buf + 10, &k.hi, 8);
  } else {
    buf[0] = 0x06;
    std::memcpy(buf + 1, &k.lo, 8);
    std::memcpy(buf + 9, &k.hi, 8);
    buf[17] = 0x00;
  }
  uint8_t digest[16];
  blake2b_hash(digest, 16, buf, 18);
  uint64_t lo, hi;
  std::memcpy(&lo, digest, 8);
  std::memcpy(&hi, digest + 8, 8);
  return pylong_from_u128(lo, hi);
}

// one null-padded outer row: (okey, (key, None, row, None), diff) when
// null_side == 1 (right null), or (okey, (None, key, None, row), diff)
static int join_emit_null(PyObject *out, int null_side, PyObject *key,
                          PyObject *row, const joinx::U128 &kh,
                          long long diff) {
  PyObject *okey = join_okey_null(null_side == 0, kh);
  if (!okey) return -1;
  PyObject *payload =
      null_side == 1 ? PyTuple_Pack(4, key, Py_None, row, Py_None)
                     : PyTuple_Pack(4, Py_None, key, Py_None, row);
  PyObject *pdiff = payload ? PyLong_FromLongLong(diff) : nullptr;
  PyObject *item = pdiff ? PyTuple_New(3) : nullptr;
  if (!item) {
    Py_DECREF(okey);
    Py_XDECREF(payload);
    Py_XDECREF(pdiff);
    return -1;
  }
  PyTuple_SET_ITEM(item, 0, okey);
  PyTuple_SET_ITEM(item, 1, payload);
  PyTuple_SET_ITEM(item, 2, pdiff);
  int rc = PyList_Append(out, item);
  Py_DECREF(item);
  return rc;
}

static int join_emit(PyObject *out, int mode, PyObject *lkey, PyObject *rkey,
                     PyObject *lrow, PyObject *rrow, const joinx::U128 &lk,
                     const joinx::U128 &rk, PyObject *diff) {
  PyObject *okey = join_okey(mode, lkey, rkey, lk, rk);
  if (!okey) return -1;
  PyObject *payload = PyTuple_Pack(4, lkey, rkey, lrow, rrow);
  if (!payload) {
    Py_DECREF(okey);
    return -1;
  }
  PyObject *item = PyTuple_New(3);
  if (!item) {
    Py_DECREF(okey);
    Py_DECREF(payload);
    return -1;
  }
  Py_INCREF(diff);
  PyTuple_SET_ITEM(item, 0, okey);
  PyTuple_SET_ITEM(item, 1, payload);
  PyTuple_SET_ITEM(item, 2, diff);
  int rc = PyList_Append(out, item);
  Py_DECREF(item);
  return rc;
}

// apply one side's deltas: probe the other side, then update own index.
// side 0 = deltas are left rows, 1 = right rows.  *replaced is set when an
// insert overwrote an existing row key (cleanliness analysis cares).
// mine_outer = THIS side is outer (its unmatched rows get null pads);
// other_outer = the probed side is outer (its rows' match counts
// transition as this side's deltas arrive) — the exact bookkeeping of
// JoinNode.step's row path.
static int join_apply_side(joinx::Index *ix, int side, PyObject *deltas,
                           PyObject *idxs, int mode, PyObject *out,
                           bool *replaced, bool mine_outer,
                           bool other_outer) {
  auto &mine = ix->sides[side];
  auto &other = ix->sides[1 - side];
  PyObject *seq = PySequence_Fast(deltas, "join deltas must be a sequence");
  if (!seq) return -1;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  mine.reserve(mine.size() + (size_t)n);
  Buf buf;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *key = PyTuple_GET_ITEM(d, 0);
    PyObject *row = PyTuple_GET_ITEM(d, 1);
    PyObject *diff = PyTuple_GET_ITEM(d, 2);
    long long dval = PyLong_AsLongLong(diff);
    if (dval == -1 && PyErr_Occurred()) {
      Py_DECREF(seq);
      return -1;
    }
    joinx::U128 jk;
    int st = join_key_of(row, idxs, buf, &jk);
    if (st < 0) {
      Py_DECREF(seq);
      return -1;
    }
    joinx::U128 kh;
    if (!u128_of_pylong(key, &kh)) {
      Py_DECREF(seq);
      return -1;
    }
    if (st == 0) {
      // null join key matches nothing (SQL), but an outer side still
      // carries the row with a null-padded partner
      if (mine_outer &&
          join_emit_null(out, side == 0 ? 1 : 0, key, row, kh, dval) < 0) {
        Py_DECREF(seq);
        return -1;
      }
      continue;
    }
    auto oit = other.find(jk);
    long long n_matches = oit == other.end() ? 0 : (long long)oit->second.size();
    if (oit != other.end()) {
      for (auto &e : oit->second) {
        int rc = side == 0
                     ? join_emit(out, mode, key, e.key, row, e.row, kh, e.kh,
                                 diff)
                     : join_emit(out, mode, e.key, key, e.row, row, e.kh, kh,
                                 diff);
        if (rc == 0 && other_outer) {
          // the probed row's match count transitions: its null pad
          // retracts on the first match, reappears on the last unmatch
          long long old = e.matches;
          e.matches = old + dval;
          if (old == 0 && dval > 0) {
            rc = join_emit_null(out, side == 0 ? 0 : 1, e.key, e.row, e.kh,
                                -1);
          } else if (old + dval == 0) {
            rc = join_emit_null(out, side == 0 ? 0 : 1, e.key, e.row, e.kh,
                                1);
          }
        }
        if (rc < 0) {
          Py_DECREF(seq);
          return -1;
        }
      }
    }
    if (mine_outer && n_matches == 0 &&
        join_emit_null(out, side == 0 ? 1 : 0, key, row, kh, dval) < 0) {
      Py_DECREF(seq);
      return -1;
    }
    if (dval > 0) {
      auto &bucket = mine[jk];
      joinx::Entry *found = nullptr;
      for (auto &e : bucket)
        if (e.kh == kh) {
          found = &e;
          break;
        }
      if (found) {  // replace (row path: dict put, match count kept)
        *replaced = true;
        Py_DECREF(found->key);
        Py_DECREF(found->row);
        Py_INCREF(key);
        Py_INCREF(row);
        found->key = key;
        found->row = row;
      } else {
        Py_INCREF(key);
        Py_INCREF(row);
        bucket.push_back({kh, key, row, n_matches});
      }
    } else {
      auto mit = mine.find(jk);
      if (mit != mine.end()) {
        auto &bucket = mit->second;
        for (size_t bi = 0; bi < bucket.size(); bi++)
          if (bucket[bi].kh == kh) {
            Py_DECREF(bucket[bi].key);
            Py_DECREF(bucket[bi].row);
            bucket.erase(bucket.begin() + bi);
            break;
          }
        if (bucket.empty()) mine.erase(mit);
      }
    }
  }
  Py_DECREF(seq);
  return 0;
}

// (capsule, left_deltas, right_deltas, l_idxs, r_idxs, okey_mode,
//  left_outer, right_outer) -> (out list, replaced: bool)
static PyObject *py_join_step(PyObject *, PyObject *args) {
  PyObject *cap, *dl, *dr, *l_idxs, *r_idxs;
  int mode, left_outer = 0, right_outer = 0;
  if (!PyArg_ParseTuple(args, "OOOO!O!i|ii", &cap, &dl, &dr, &PyTuple_Type,
                        &l_idxs, &PyTuple_Type, &r_idxs, &mode, &left_outer,
                        &right_outer))
    return nullptr;
  auto *ix = join_from(cap);
  if (!ix) return nullptr;
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  bool replaced = false;
  // delta-join rule: dL against R, then dR against L' (already incl. dL)
  if (join_apply_side(ix, 0, dl, l_idxs, mode, out, &replaced,
                      left_outer != 0, right_outer != 0) < 0 ||
      join_apply_side(ix, 1, dr, r_idxs, mode, out, &replaced,
                      right_outer != 0, left_outer != 0) < 0) {
    Py_DECREF(out);
    return nullptr;
  }
  PyObject *res = Py_BuildValue("(Oi)", out, replaced ? 1 : 0);
  Py_DECREF(out);
  return res;
}

// (capsule) -> ([(key, row), ...] left, [(key, row), ...] right) — for
// operator snapshots; join keys are recomputed from the rows on load
static PyObject *py_join_dump(PyObject *, PyObject *arg) {
  auto *ix = join_from(arg);
  if (!ix) return nullptr;
  PyObject *sides[2] = {nullptr, nullptr};
  for (int s = 0; s < 2; s++) {
    PyObject *lst = PyList_New(0);
    if (!lst) {
      Py_XDECREF(sides[0]);
      return nullptr;
    }
    for (auto &b : ix->sides[s])
      for (auto &e : b.second) {
        PyObject *pair = PyTuple_Pack(2, e.key, e.row);
        if (!pair || PyList_Append(lst, pair) < 0) {
          Py_XDECREF(pair);
          Py_DECREF(lst);
          Py_XDECREF(sides[0]);
          return nullptr;
        }
        Py_DECREF(pair);
      }
    sides[s] = lst;
  }
  PyObject *res = PyTuple_Pack(2, sides[0], sides[1]);
  Py_DECREF(sides[0]);
  Py_DECREF(sides[1]);
  return res;
}

// (capsule, side, items, idxs) -> None; re-inserts snapshot rows
static PyObject *py_join_load(PyObject *, PyObject *args) {
  PyObject *cap, *items, *idxs;
  int side;
  if (!PyArg_ParseTuple(args, "OiOO!", &cap, &side, &items, &PyTuple_Type,
                        &idxs))
    return nullptr;
  auto *ix = join_from(cap);
  if (!ix || side < 0 || side > 1) {
    if (ix) PyErr_SetString(PyExc_ValueError, "side must be 0 or 1");
    return nullptr;
  }
  PyObject *seq = PySequence_Fast(items, "join_load expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  Buf buf;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *pair = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *key = PyTuple_GET_ITEM(pair, 0);
    PyObject *row = PyTuple_GET_ITEM(pair, 1);
    joinx::U128 jk, kh;
    int st = join_key_of(row, idxs, buf, &jk);
    if (st < 0 || (st == 1 && !u128_of_pylong(key, &kh))) {
      Py_DECREF(seq);
      return nullptr;
    }
    if (st == 0) continue;
    auto &bucket = ix->sides[side][jk];
    joinx::Entry *found = nullptr;
    for (auto &e : bucket)
      if (e.kh == kh) { found = &e; break; }
    Py_INCREF(key);
    Py_INCREF(row);
    if (found) {
      Py_DECREF(found->key);
      Py_DECREF(found->row);
      found->key = key;
      found->row = row;
    } else {
      bucket.push_back({kh, key, row});
    }
  }
  Py_DECREF(seq);
  // recount outer match counters from the live invariant (count = size of
  // the other side's bucket); cheap, and correct whichever side loads last
  for (int s = 0; s < 2; s++) {
    auto &other = ix->sides[1 - s];
    for (auto &b : ix->sides[s]) {
      auto oit = other.find(b.first);
      long long m = oit == other.end() ? 0 : (long long)oit->second.size();
      for (auto &e : b.second) e.matches = m;
    }
  }
  Py_RETURN_NONE;
}

// Pointer(key) without the Python-level call: tp_alloc + slot store.
// Engine keys are already & KEY_MASK (KEY_MASK = 2^128-1, an identity for
// the non-negative 128-bit hashes every key derives from), so skipping
// __init__'s mask is exact.
static PyObject *make_pointer_fast(PyObject *key) {
  static PyObject *value_name = nullptr;
  if (!value_name) {
    value_name = PyUnicode_InternFromString("value");
    if (!value_name) return nullptr;
  }
  PyTypeObject *tp = (PyTypeObject *)g_pointer_cls;
  PyObject *obj = tp->tp_alloc(tp, 0);
  if (!obj) return nullptr;
  if (PyObject_SetAttr(obj, value_name, key) < 0) {
    Py_DECREF(obj);
    return nullptr;
  }
  return obj;
}

// (deltas, spec) -> ([(key, projected_row, diff)], err_keys | None) — the
// join-select projection over (lkey, rkey, lrow, rrow) payload rows in
// one C pass.  spec entries: (src, idx) with src 0 = lrow[idx] (None when
// lrow is None), 1 = rrow[idx], 2 = Pointer(lkey) or None, 3 =
// Pointer(rkey) or None, 4 = Pointer(out key).  Mirrors table.py
// JoinBinder accessors.  err_keys lists keys of inserted rows whose
// projection carries an Error value (the row path logs those; parity).
// Returns None (not an exception) on any malformed payload shape — the
// caller then falls back to the row interpreter, like the other native
// fast paths in this file.
static PyObject *py_project_join_rows(PyObject *, PyObject *args) {
  PyObject *deltas, *spec;
  if (!PyArg_ParseTuple(args, "OO!", &deltas, &PyTuple_Type, &spec))
    return nullptr;
  Py_ssize_t n_out = PyTuple_GET_SIZE(spec);
  // decode the spec once
  std::vector<std::pair<long, long>> cols(n_out);
  for (Py_ssize_t i = 0; i < n_out; i++) {
    PyObject *entry = PyTuple_GET_ITEM(spec, i);
    cols[i] = {PyLong_AsLong(PyTuple_GET_ITEM(entry, 0)),
               PyLong_AsLong(PyTuple_GET_ITEM(entry, 1))};
    if (PyErr_Occurred()) return nullptr;
  }
  PyObject *seq = PySequence_Fast(deltas, "project expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject *out = PyList_New(n);
  PyObject *err_keys = nullptr;
  PyTypeObject *err_type = Py_TYPE(g_error_obj);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  // 0 = ok, 1 = bail (fall back to the row path), 2 = error set
  auto one = [&](Py_ssize_t i) -> int {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyTuple_Check(d) || PyTuple_GET_SIZE(d) != 3) return 1;
    PyObject *key = PyTuple_GET_ITEM(d, 0);
    PyObject *payload = PyTuple_GET_ITEM(d, 1);
    PyObject *diff = PyTuple_GET_ITEM(d, 2);
    if (!PyTuple_Check(payload) || PyTuple_GET_SIZE(payload) != 4) return 1;
    PyObject *lkey = PyTuple_GET_ITEM(payload, 0);
    PyObject *rkey = PyTuple_GET_ITEM(payload, 1);
    PyObject *lrow = PyTuple_GET_ITEM(payload, 2);
    PyObject *rrow = PyTuple_GET_ITEM(payload, 3);
    PyObject *row = PyTuple_New(n_out);
    bool has_err = false;
    if (!row) return 2;
    for (Py_ssize_t c = 0; c < n_out; c++) {
      long src_ = cols[c].first, idx = cols[c].second;
      PyObject *v = nullptr;
      switch (src_) {
        case 0:
        case 1: {
          PyObject *r = src_ == 0 ? lrow : rrow;
          if (r == Py_None) {
            Py_INCREF(Py_None);
            v = Py_None;
          } else {
            if (!PyTuple_Check(r) || idx >= PyTuple_GET_SIZE(r)) {
              Py_DECREF(row);
              return 1;
            }
            v = PyTuple_GET_ITEM(r, idx);
            if (Py_TYPE(v) == err_type) has_err = true;
            Py_INCREF(v);
          }
          break;
        }
        case 2:
        case 3: {
          PyObject *k = src_ == 2 ? lkey : rkey;
          if (k == Py_None) {
            Py_INCREF(Py_None);
            v = Py_None;
          } else {
            v = make_pointer_fast(k);
          }
          break;
        }
        case 4:
          v = make_pointer_fast(key);
          break;
        default:
          PyErr_SetString(PyExc_ValueError, "bad projection src");
      }
      if (!v) {
        Py_DECREF(row);
        return 2;
      }
      PyTuple_SET_ITEM(row, c, v);
    }
    if (has_err) {
      // row-path parity: an inserted row whose projection carries an
      // Error cell is logged (the payload itself never holds a top-level
      // Error, so the row path's "new Error" condition reduces to this)
      long long dv = PyLong_AsLongLong(diff);
      if (dv == -1 && PyErr_Occurred()) {
        Py_DECREF(row);
        return 2;
      }
      if (dv > 0) {
        if (!err_keys) {
          err_keys = PyList_New(0);
          if (!err_keys) {
            Py_DECREF(row);
            return 2;
          }
        }
        if (PyList_Append(err_keys, key) < 0) {
          Py_DECREF(row);
          return 2;
        }
      }
    }
    PyObject *item = PyTuple_New(3);
    if (!item) {
      Py_DECREF(row);
      return 2;
    }
    Py_INCREF(key);
    Py_INCREF(diff);
    PyTuple_SET_ITEM(item, 0, key);
    PyTuple_SET_ITEM(item, 1, row);
    PyTuple_SET_ITEM(item, 2, diff);
    PyList_SET_ITEM(out, i, item);
    return 0;
  };
  for (Py_ssize_t i = 0; i < n; i++) {
    int rc = one(i);
    if (rc == 0) continue;
    Py_DECREF(seq);
    Py_DECREF(out);
    Py_XDECREF(err_keys);
    if (rc == 1) Py_RETURN_NONE;  // malformed: caller uses the row path
    return nullptr;
  }
  Py_DECREF(seq);
  PyObject *res =
      Py_BuildValue("(OO)", out, err_keys ? err_keys : Py_None);
  Py_DECREF(out);
  Py_XDECREF(err_keys);
  return res;
}

// (deltas, col_idx, with_origin) -> [(new_key, new_row, diff)] or None.
// The Table.flatten hot loop in one C pass: one output row per element of
// the iterable column, new_key = hash_values([Pointer(key), pos]) built
// without Python objects, tuple splice in C.  None = bail to the row path
// (malformed rows); non-iterable cell values flatten as a single item and
// None cells emit nothing, exactly like the Python fn.
static PyObject *py_flatten_deltas(PyObject *, PyObject *args) {
  PyObject *deltas;
  Py_ssize_t col_idx;
  int with_origin;
  if (!PyArg_ParseTuple(args, "Oni", &deltas, &col_idx, &with_origin))
    return nullptr;
  PyObject *seq = PySequence_Fast(deltas, "flatten expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  // shape prevalidation BEFORE any cell is touched: the bail-to-row-path
  // contract must be side-effect-free (a one-shot iterator cell consumed
  // by a partial native pass would be empty when the row path re-runs)
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyTuple_Check(d) || PyTuple_GET_SIZE(d) != 3 ||
        !PyLong_Check(PyTuple_GET_ITEM(d, 0)) ||
        !PyTuple_Check(PyTuple_GET_ITEM(d, 1)) ||
        col_idx >= PyTuple_GET_SIZE(PyTuple_GET_ITEM(d, 1))) {
      Py_DECREF(seq);
      Py_RETURN_NONE;  // malformed: the row path handles it
    }
  }
  PyObject *out = PyList_New(0);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  // 0 ok; 2 error (shapes already validated — no bail from here on)
  auto one = [&](Py_ssize_t i) -> int {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *key = PyTuple_GET_ITEM(d, 0);
    PyObject *row = PyTuple_GET_ITEM(d, 1);
    PyObject *diff = PyTuple_GET_ITEM(d, 2);
    Py_ssize_t width = PyTuple_GET_SIZE(row);
    PyObject *cell = PyTuple_GET_ITEM(row, col_idx);
    if (cell == Py_None) return 0;  // None flattens to nothing
    PyObject *items = PySequence_Fast(cell, "");
    bool single = false;
    if (!items) {
      // the row path's contract: only TypeError means "not iterable —
      // flatten as a single item"; anything else propagates
      if (!PyErr_ExceptionMatches(PyExc_TypeError)) return 2;
      PyErr_Clear();
      single = true;
    }
    Py_ssize_t m = single ? 1 : PySequence_Fast_GET_SIZE(items);
    joinx::U128 kh;
    if (!u128_of_pylong(key, &kh)) {
      Py_XDECREF(items);
      return 2;
    }
    // ser prefix: Pointer tag + 16-byte key (shared by every position)
    uint8_t buf[1 + 16 + 1 + 16];
    buf[0] = 0x06;
    std::memcpy(buf + 1, &kh.lo, 8);
    std::memcpy(buf + 9, &kh.hi, 8);
    buf[17] = 0x02;  // int tag; positions are small non-negative ints
    PyObject *origin = nullptr;
    if (with_origin) {
      origin = make_pointer_fast(key);
      if (!origin) {
        Py_XDECREF(items);
        return 2;
      }
    }
    int rc = 0;
    for (Py_ssize_t pos = 0; pos < m && rc == 0; pos++) {
      PyObject *item =
          single ? cell : PySequence_Fast_GET_ITEM(items, pos);
      int64_t p = (int64_t)pos;
      std::memcpy(buf + 18, &p, 8);
      std::memset(buf + 26, 0, 8);  // i128 little-endian, non-negative
      uint8_t digest[16];
      blake2b_hash(digest, 16, buf, sizeof(buf));
      uint64_t lo, hi;
      std::memcpy(&lo, digest, 8);
      std::memcpy(&hi, digest + 8, 8);
      PyObject *new_key = pylong_from_u128(lo, hi);
      PyObject *new_row = PyTuple_New(width + (with_origin ? 1 : 0));
      if (!new_key || !new_row) {
        Py_XDECREF(new_key);
        Py_XDECREF(new_row);
        rc = 2;
        break;
      }
      for (Py_ssize_t c = 0; c < width; c++) {
        PyObject *v = c == col_idx ? item : PyTuple_GET_ITEM(row, c);
        Py_INCREF(v);
        PyTuple_SET_ITEM(new_row, c, v);
      }
      if (with_origin) {
        Py_INCREF(origin);
        PyTuple_SET_ITEM(new_row, width, origin);
      }
      PyObject *entry = PyTuple_New(3);
      if (!entry) {
        Py_DECREF(new_key);
        Py_DECREF(new_row);
        rc = 2;
        break;
      }
      Py_INCREF(diff);
      PyTuple_SET_ITEM(entry, 0, new_key);
      PyTuple_SET_ITEM(entry, 1, new_row);
      PyTuple_SET_ITEM(entry, 2, diff);
      if (PyList_Append(out, entry) < 0) rc = 2;
      Py_DECREF(entry);
    }
    Py_XDECREF(origin);
    Py_XDECREF(items);
    return rc;
  };
  for (Py_ssize_t i = 0; i < n; i++) {
    if (one(i) != 0) {
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;  // exception set; errors propagate, never re-run
    }
  }
  Py_DECREF(seq);
  return out;
}

// (deltas, salt) -> [(hash_values([Pointer(key), salt]), row, diff)] or
// None when a key is not a plain int (row path handles it).  Injective
// for distinct keys at a fixed salt — the salted-branch rekey of the
// vectorized sliding-window assignment.
static PyObject *py_rekey_deltas(PyObject *, PyObject *args) {
  PyObject *deltas;
  long long salt;
  if (!PyArg_ParseTuple(args, "OL", &deltas, &salt)) return nullptr;
  PyObject *seq = PySequence_Fast(deltas, "rekey expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyTuple_Check(d) || PyTuple_GET_SIZE(d) != 3 ||
        !PyLong_Check(PyTuple_GET_ITEM(d, 0))) {
      Py_DECREF(seq);
      Py_RETURN_NONE;
    }
  }
  PyObject *out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  uint8_t buf[1 + 16 + 1 + 16];
  buf[0] = 0x06;
  buf[17] = 0x02;
  int64_t s = (int64_t)salt;
  std::memcpy(buf + 18, &s, 8);
  std::memset(buf + 26, s < 0 ? 0xFF : 0x00, 8);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *d = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *key = PyTuple_GET_ITEM(d, 0);
    joinx::U128 kh;
    if (!u128_of_pylong(key, &kh)) {
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    std::memcpy(buf + 1, &kh.lo, 8);
    std::memcpy(buf + 9, &kh.hi, 8);
    uint8_t digest[16];
    blake2b_hash(digest, 16, buf, sizeof(buf));
    uint64_t lo, hi;
    std::memcpy(&lo, digest, 8);
    std::memcpy(&hi, digest + 8, 8);
    PyObject *new_key = pylong_from_u128(lo, hi);
    PyObject *entry = new_key ? PyTuple_New(3) : nullptr;
    if (!entry) {
      Py_XDECREF(new_key);
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    PyObject *row = PyTuple_GET_ITEM(d, 1);
    PyObject *diff = PyTuple_GET_ITEM(d, 2);
    Py_INCREF(row);
    Py_INCREF(diff);
    PyTuple_SET_ITEM(entry, 0, new_key);
    PyTuple_SET_ITEM(entry, 1, row);
    PyTuple_SET_ITEM(entry, 2, diff);
    PyList_SET_ITEM(out, i, entry);
  }
  Py_DECREF(seq);
  return out;
}

static PyObject *py_join_stats(PyObject *, PyObject *arg) {
  auto *ix = join_from(arg);
  if (!ix) return nullptr;
  size_t counts[2] = {0, 0};
  for (int s = 0; s < 2; s++)
    for (auto &b : ix->sides[s]) counts[s] += b.second.size();
  return Py_BuildValue("(kk)", (unsigned long)counts[0],
                       (unsigned long)counts[1]);
}

static PyMethodDef methods[] = {
    {"join_new", py_join_new, METH_NOARGS, "native equi-join index capsule"},
    {"join_step", py_join_step, METH_VARARGS,
     "(capsule, dl, dr, l_idxs, r_idxs, okey_mode) -> output deltas"},
    {"join_dump", py_join_dump, METH_O,
     "(capsule) -> (left [(key, row)], right [(key, row)])"},
    {"join_load", py_join_load, METH_VARARGS,
     "(capsule, side, items, idxs) re-inserts snapshot rows"},
    {"join_stats", py_join_stats, METH_O, "(capsule) -> (n_left, n_right)"},
    {"project_join_rows", py_project_join_rows, METH_VARARGS,
     "(join deltas, ((src, idx), ...)) -> projected deltas"},
    {"flatten_deltas", py_flatten_deltas, METH_VARARGS,
     "(deltas, col_idx, with_origin) -> flattened deltas or None"},
    {"rekey_deltas", py_rekey_deltas, METH_VARARGS,
     "(deltas, salt) -> salted-hash rekeyed deltas or None"},
    {"materialize_columns", py_materialize_columns, METH_VARARGS,
     "(rows|deltas, needed tuple, from_deltas) -> {idx: (kind, buf|list)} "
     "or None on bail"},
    {"rebuild_delta_rows", py_rebuild_delta_rows, METH_VARARGS,
     "(deltas, [(kind, buf|list|src_idx), ...]) -> [(key, row, diff), ...]"},
    {"filter_deltas", py_filter_deltas, METH_VARARGS,
     "(deltas, uint8 mask buffer, n_cols) -> kept deltas, rows truncated"},
    {"split_deltas", py_split_deltas, METH_VARARGS,
     "(deltas, uint8 mask buffer) -> (kept, dropped), rows untouched"},
    {"gather_key_rows", py_gather_key_rows, METH_VARARGS,
     "(deltas, idxs) -> per-row key tuples (multi-column group keys)"},
    {"freeze_scan", py_freeze_scan, METH_VARARGS,
     "(kind, t buffer, thr buffer, watermark|None) -> (keep mask, new "
     "watermark) — FreezeNode's sequential admit/advance scan"},
    {"route_deltas", py_route_deltas, METH_VARARGS,
     "(deltas, key_idxs, n_dest, hash_none) -> per-destination delta "
     "lists (exchange shard routing, hash_values-compatible)"},
    {"stage_static", py_stage_static, METH_VARARGS,
     "(quads, clean_list_cls) -> [(time, deltas, clean)] partition + "
     "cleanliness proof; clean buckets built as clean_list_cls"},
    {"group_indices", py_group_indices, METH_O,
     "(values) -> (uniques, int64 inverse bytearray) hash grouping"},
    {"delta_diffs", py_delta_diffs, METH_O,
     "(deltas) -> int64 bytearray of diffs (None when beyond int64)"},
    {"hnsw_new", py_hnsw_new, METH_VARARGS,
     "HNSW index: (dim, metric, m, ef_construction, seed) -> capsule"},
    {"hnsw_add", py_hnsw_add, METH_VARARGS,
     "(capsule, float32 buffer) -> dense node id"},
    {"hnsw_remove", py_hnsw_remove, METH_VARARGS, "(capsule, id) tombstone"},
    {"hnsw_search", py_hnsw_search, METH_VARARGS,
     "(capsule, query buffer, k, ef) -> [(id, dist)] live nodes, ascending"},
    {"hnsw_get_vector", py_hnsw_get_vector, METH_VARARGS,
     "(capsule, id) -> float32 bytes of the stored (prepped) vector"},
    {"hnsw_stats", py_hnsw_stats, METH_O, "(capsule) -> (n_total, n_dead)"},
    {"setup", py_setup, METH_VARARGS, "register engine classes and helpers"},
    {"hash_values", py_hash_values, METH_O, "stable 128-bit value hash"},
    {"blake2b_128", py_blake2b_128, METH_O, "blake2b-128 digest"},
    {"encode_row", py_encode_row, METH_O, "PWT1-encode a row"},
    {"encode_events", py_encode_events, METH_O,
     "PWT1-encode a batch of snapshot events"},
    {"crc32c", py_crc32c, METH_VARARGS,
     "CRC-32C (Castagnoli), hardware-accelerated, GIL-released"},
    {"decode_row", py_decode_row, METH_VARARGS, "PWT1-decode a row"},
    {"upsert_chain", py_upsert_chain, METH_VARARGS,
     "(deltas, state) -> chained retract+insert delta list"},
    {"consolidate_dirty", py_consolidate_dirty, METH_O,
     "accumulate a known-dirty delta list (retractions first)"},
    {"sequential_keys", py_sequential_keys, METH_VARARGS,
     "bulk sequential row keys: blake2b16(salt + le16(start+i))"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_native",
                                       "pathway_tpu_torch native runtime core", -1,
                                       methods};

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
