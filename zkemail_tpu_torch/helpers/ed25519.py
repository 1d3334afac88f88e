"""Ed25519 (RFC 8032 §5.1) in Python integers, for ed25519-sha256 DKIM.

The JAX package signs and verifies ed25519 through the ``cryptography``
package, which the port does without. This module is RFC 8032's reference
arithmetic: points in extended coordinates (§5.1.4), decoding with the
square root mod p (§5.1.3), signing (§5.1.6) and verification (§5.1.7).

Verification decides as OpenSSL's (which ``cryptography`` calls): it
refuses S >= L and a public key with no x for its y, reads the key's y mod
p and lets x = 0 carry either sign bit, and compares the encoding of
[S]B - [k]A with the signature's R bytes, so a non-canonical R never
verifies.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # the group order
D = -121665 * pow(121666, -1, P) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _sha512_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def point_add(p, q):
    """Extended-coordinate addition (RFC 8032 §5.1.4); complete on edwards25519."""
    a = (p[1] - p[0]) * (q[1] - q[0]) % P
    b = (p[1] + p[0]) * (q[1] + q[0]) % P
    c = 2 * p[3] * q[3] * D % P
    d = 2 * p[2] * q[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_mul(s: int, p):
    q = (0, 1, 1, 0)  # the neutral element
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def _recover_x(y: int, sign: int):
    """x from y < p and the sign bit (§5.1.3 steps 2-4); None if none
    exists. x = 0 takes either sign bit, as OpenSSL's decoding."""
    x2 = (y * y - 1) * pow(D * y * y + 1, -1, P) % P
    if x2 == 0:
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if x & 1 != sign:
        x = P - x
    return x


G_Y = 4 * pow(5, -1, P) % P
G_X = _recover_x(G_Y, 0)
BASE = (G_X, G_Y, 1, G_X * G_Y % P)


def point_encode(p) -> bytes:
    zinv = pow(p[2], -1, P)
    x, y = p[0] * zinv % P, p[1] * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decode(s: bytes):
    """A 32-byte encoding -> extended point, or None (§5.1.3, with y read
    mod p as OpenSSL reads it)."""
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y = (y & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _secret_expand(secret: bytes):
    if len(secret) != 32:
        raise ValueError("an ed25519 secret key is 32 bytes")
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    """The 32-byte public key of a 32-byte secret (§5.1.5)."""
    a, _ = _secret_expand(secret)
    return point_encode(point_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    """PureEdDSA signature R || S of `msg` (§5.1.6)."""
    a, prefix = _secret_expand(secret)
    a_enc = point_encode(point_mul(a, BASE))
    r = _sha512_int(prefix, msg) % L
    r_enc = point_encode(point_mul(r, BASE))
    k = _sha512_int(r_enc, a_enc, msg) % L
    return r_enc + ((r + k * a) % L).to_bytes(32, "little")


def verify(public: bytes, msg: bytes, signature: bytes) -> bool:
    """PureEdDSA verification (§5.1.7): [S]B - [k]A must encode to R."""
    if len(public) != 32 or len(signature) != 64:
        return False
    a = point_decode(public)
    if a is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    k = _sha512_int(signature[:32], public, msg) % L
    neg_a = (P - a[0], a[1], a[2], P - a[3])
    r = point_add(point_mul(s, BASE), point_mul(k, neg_a))
    return point_encode(r) == signature[:32]
