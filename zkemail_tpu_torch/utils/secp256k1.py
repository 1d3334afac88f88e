"""Minimal pure-Python secp256k1 ECDSA: sign / recover (Ethereum style).

Host-side mirror of the EVM `ecrecover` precompile so the contract models in
contracts/reference_impl.py can execute the reference's ECDSA-gated registry
flows (packages/contracts/ECDSAOwnedDKIMRegistry.sol:58-61,
UserOverrideableDKIMRegistry.sol relayer signatures) without an EVM.
Deterministic nonces (RFC 6979 style via HMAC-SHA256) keep tests hermetic.

A copy of ``zkemail_tpu/utils/secp256k1.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import hmac

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = 3 * x1 * x1 * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def privkey_to_address(priv: int) -> str:
    """Ethereum address: keccak256(uncompressed pubkey)[12:]."""
    from .keccak import keccak_256

    x, y = _mul(priv, (Gx, Gy))
    pub = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return "0x" + keccak_256(pub)[12:].hex()


def _rfc6979_k(priv: int, digest: bytes) -> int:
    key = priv.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + key + digest, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + key + digest, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(priv: int, digest: bytes) -> tuple[int, int, int]:
    """ECDSA sign a 32-byte digest -> (v, r, s) with low-s and v in {27, 28}."""
    z = int.from_bytes(digest, "big")
    k = _rfc6979_k(priv, digest)
    x, y = _mul(k, (Gx, Gy))
    r = x % N
    s = _inv(k, N) * (z + r * priv) % N
    rec = (y & 1) ^ (1 if x >= N else 0)
    if s > N // 2:  # EIP-2 low-s normalization flips recovery parity
        s = N - s
        rec ^= 1
    return 27 + rec, r, s


def recover(digest: bytes, v: int, r: int, s: int) -> str | None:
    """ecrecover precompile mirror -> checksummed-less hex address or None."""
    if not (1 <= r < N and 1 <= s < N) or v not in (27, 28):
        return None
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if (y & 1) != (v - 27):
        y = P - y
    z = int.from_bytes(digest, "big")
    r_inv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    pt = _add(_mul(s, (x, y)), _mul((N - z) % N, (Gx, Gy)))
    q = _mul(r_inv, pt)
    if q is None:
        return None
    from .keccak import keccak_256

    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return "0x" + keccak_256(pub)[12:].hex()


def sig_bytes(v: int, r: int, s: int) -> bytes:
    """65-byte r || s || v encoding used by the contracts."""
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
