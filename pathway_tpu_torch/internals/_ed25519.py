"""Pure-Python Ed25519 (RFC 8032) — fallback for offline license files.

The license layer (``internals/license.py``) verifies ed25519-signed
offline license files.  The reference build links a Rust ed25519 crate;
here the preferred implementation is the ``cryptography`` wheel, but the
container this framework targets may not ship it — and a missing
*optional* dependency must degrade to a slower implementation, not to
``ModuleNotFoundError`` at import time.

This is the RFC 8032 reference construction with extended homogeneous
coordinates (the complete addition formula of §5.1.4), so verification
costs two scalar multiplications at a few tens of milliseconds — entirely
acceptable for the handful of license checks a process performs, and
deterministic signing means signatures are byte-identical to the
``cryptography`` wheel's.

NOT constant-time: fine for license *verification* against a public key,
and for the test-fixture signer; do not reuse for online protocols
handling attacker-timed secret keys.
"""

from __future__ import annotations

import hashlib

__all__ = ["publickey", "sign", "verify"]

_p = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493


def _inv(x: int) -> int:
    return pow(x, _p - 2, _p)


_d = (-121665 * _inv(121666)) % _p
_SQRT_M1 = pow(2, (_p - 1) // 4, _p)  # sqrt(-1) mod p

# base point B: y = 4/5, x recovered even
_g_y = (4 * _inv(5)) % _p


def _recover_x(y: int, sign: int) -> int | None:
    if y >= _p:
        return None
    x2 = (y * y - 1) * _inv(_d * y * y + 1) % _p
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (_p + 3) // 8, _p)
    if (x * x - x2) % _p != 0:
        x = x * _SQRT_M1 % _p
    if (x * x - x2) % _p != 0:
        return None
    if (x & 1) != sign:
        x = _p - x
    return x


_g_x = _recover_x(_g_y, 0)
# extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z
_G = (_g_x, _g_y, 1, _g_x * _g_y % _p)
_IDENT = (0, 1, 1, 0)


def _add(P: tuple, Q: tuple) -> tuple:
    """Complete twisted-Edwards addition (RFC 8032 §5.1.4)."""
    x1, y1, z1, t1 = P
    x2, y2, z2, t2 = Q
    a = (y1 - x1) * (y2 - x2) % _p
    b = (y1 + x1) * (y2 + x2) % _p
    c = 2 * t1 * t2 * _d % _p
    dd = 2 * z1 * z2 % _p
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % _p, g * h % _p, f * g % _p, e * h % _p)


def _mul(s: int, P: tuple) -> tuple:
    Q = _IDENT
    while s > 0:
        if s & 1:
            Q = _add(Q, P)
        P = _add(P, P)
        s >>= 1
    return Q


def _compress(P: tuple) -> bytes:
    x, y, z, _t = P
    zinv = _inv(z)
    x, y = x * zinv % _p, y * zinv % _p
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(data: bytes) -> tuple | None:
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % _p)


def _equal(P: tuple, Q: tuple) -> bool:
    x1, y1, z1, _ = P
    x2, y2, z2, _ = Q
    return (x1 * z2 - x2 * z1) % _p == 0 and (y1 * z2 - y2 * z1) % _p == 0


def _sha512_modq(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little") % _L


def _expand(secret: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def publickey(secret: bytes) -> bytes:
    """32-byte public key of a 32-byte seed."""
    if len(secret) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    a, _prefix = _expand(secret)
    return _compress(_mul(a, _G))


def sign(secret: bytes, message: bytes) -> bytes:
    """Deterministic RFC 8032 signature (64 bytes) over ``message``."""
    a, prefix = _expand(secret)
    A = _compress(_mul(a, _G))
    r = _sha512_modq(prefix + message)
    Rs = _compress(_mul(r, _G))
    k = _sha512_modq(Rs + A + message)
    s = (r + k * a) % _L
    return Rs + int.to_bytes(s, 32, "little")


def verify(public: bytes, signature: bytes, message: bytes) -> bool:
    """True iff ``signature`` is a valid signature of ``message``."""
    if len(public) != 32 or len(signature) != 64:
        return False
    A = _decompress(public)
    R = _decompress(signature[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    k = _sha512_modq(signature[:32] + public + message)
    return _equal(_mul(s, _G), _add(R, _mul(k, A)))
