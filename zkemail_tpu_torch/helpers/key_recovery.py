"""Recover a DKIM RSA public modulus from two signed emails (GCD attack).

The port of ``zkemail_tpu/helpers/key_recovery.py``, a host path. Test
suites that resolve fixture keys over live DNS cannot run without network
egress, but an RSA public key is recoverable from public data alone: for
PKCS#1 v1.5, n divides s^e - EM(m) for every signature s over message m, so

    n = gcd(s1^e - EM(m1), s2^e - EM(m2))   (up to small cofactors)

given two emails signed by the same key. The intermediate integers are
~2048*65537 bits, so the gcd runs through system libgmp (subquadratic) via
ctypes; CPython's quadratic math.gcd, taken when libgmp is absent, would
take hours at that size.

One difference from the JAX module: EM(m) is encoded at the key's length,
bits_hint / 8 bytes, where the JAX module encodes it at max(signature
bytes, 256) and so recovers no key shorter than 2048 bits.

Used by scripts/recover_dkim_key.py.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import math
import re

from . import dkim as D

_ASN1_SHA256 = bytes.fromhex("3031300d060960864801650304020105000420")
_E = 65537


def _em_int(digest: bytes, k: int = 256) -> int:
    """EMSA-PKCS1-v1_5 encoding of a SHA-256 digest as an integer."""
    ff = k - 3 - len(_ASN1_SHA256) - 32
    return int.from_bytes(
        b"\x00\x01" + b"\xff" * ff + b"\x00" + _ASN1_SHA256 + digest, "big"
    )


def signature_and_message(raw_email: bytes, sig_index: int = 0,
                          k: int | None = None) -> tuple[int, int]:
    """(signature int, EM(message) int) of the sig_index-th DKIM signature,
    EM encoded at k bytes (default: max(signature bytes, 256), as the JAX
    module)."""
    parsed = D.parse_message(raw_email)
    seen = 0
    for name, raw_line, value in parsed.headers:
        if name != "dkim-signature":
            continue
        if seen == sig_index:
            tags = D.parse_tags(value)
            base = D.build_signature_base(parsed, raw_line, tags)
            sig = int.from_bytes(
                base64.b64decode(re.sub(r"\s", "", tags["b"])), "big"
            )
            klen = (sig.bit_length() + 7) // 8
            return sig, _em_int(hashlib.sha256(base).digest(), k or max(klen, 256))
        seen += 1
    raise ValueError(f"no DKIM signature #{sig_index} in message")


class _Gmp:
    """Minimal libgmp mpz bindings (import/export + pow_ui/sub/gcd)."""

    class mpz_t(ctypes.Structure):
        _fields_ = [
            ("alloc", ctypes.c_int),
            ("size", ctypes.c_int),
            ("d", ctypes.c_void_p),
        ]

    def __init__(self):
        lib = ctypes.CDLL("libgmp.so.10")
        # getattr: "__gmpz_*" written literally would be name-mangled in a class
        self.fn = {
            name: getattr(lib, "__gmpz_" + name)
            for name in ("init", "import", "export", "sizeinbase", "pow_ui",
                         "sub", "gcd", "set")
        }
        self.fn["export"].restype = ctypes.c_void_p

    def new(self):
        z = self.mpz_t()
        self.fn["init"](ctypes.byref(z))
        return z

    def set(self, z, v: int):
        b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        self.fn["import"](ctypes.byref(z), ctypes.c_size_t(len(b)), 1, 1, 0, 0, b)

    def get(self, z) -> int:
        nbytes = (self.fn["sizeinbase"](ctypes.byref(z), 2) + 7) // 8
        buf = ctypes.create_string_buffer(nbytes)
        cnt = ctypes.c_size_t(0)
        self.fn["export"](buf, ctypes.byref(cnt), 1, 1, 0, 0, ctypes.byref(z))
        return int.from_bytes(buf.raw[: cnt.value], "big")


def _gcd_of_sig_residues(pairs: list[tuple[int, int]]) -> int:
    """gcd over i of (s_i^e - m_i), via libgmp when available."""
    try:
        g = _Gmp()
    except OSError:
        acc = 0
        for s, m in pairs:
            acc = math.gcd(acc, pow(s, _E) - m)
        return acc
    acc_z, tmp, mz = g.new(), g.new(), g.new()
    first = True
    for s, m in pairs:
        g.set(tmp, s)
        g.fn["pow_ui"](ctypes.byref(tmp), ctypes.byref(tmp), _E)
        g.set(mz, m)
        g.fn["sub"](ctypes.byref(tmp), ctypes.byref(tmp), ctypes.byref(mz))
        if first:
            g.fn["set"](ctypes.byref(acc_z), ctypes.byref(tmp))
            first = False
        else:
            g.fn["gcd"](ctypes.byref(acc_z), ctypes.byref(acc_z), ctypes.byref(tmp))
    return g.get(acc_z)


def recover_modulus(raw_emails: list[bytes], bits_hint: int = 2048) -> int:
    """Recover the common RSA modulus of the first DKIM signature of each
    email. Requires >= 2 emails signed by the same key."""
    if len(raw_emails) < 2:
        raise ValueError("need at least two emails signed by the same key")
    pairs = [signature_and_message(e, k=(bits_hint + 7) // 8) for e in raw_emails]
    n = _gcd_of_sig_residues(pairs)
    # strip small cofactors (gcd may pick up small shared factors)
    for p in range(2, 100000):
        while n % p == 0 and n.bit_length() > bits_hint:
            n //= p
    if n.bit_length() != bits_hint:
        raise ValueError(f"recovered {n.bit_length()}-bit value, wanted {bits_hint}")
    s0, m0 = pairs[0]
    if pow(s0, _E, n) != m0 % n:
        raise ValueError("recovered modulus does not verify signature 0")
    return n
