"""Self-contained DKIM-signed test emails, from a seed.

The port of ``zkemail_tpu/helpers/testkit.py`` without the ``cryptography``
package. ``LocalDKIMSigner``'s RSA key is generated from a seeded
``random.Random`` (Miller-Rabin in Python ints, e = 65537) and the
signature is EMSA-PKCS1-v1_5 over SHA-256 by ``pow``;
``LocalEd25519DKIMSigner``'s secret is 32 seeded bytes and its signature
RFC 8032's (``helpers/ed25519.py``). The emails they write are byte for
byte the JAX signers' layout, so the same key signs the same bytes.
"""

from __future__ import annotations

import base64
import random
from dataclasses import dataclass

from . import ed25519
from .canon import canon_body
from .dkim import build_signature_base, parse_message, parse_tags
from .dns import RSA_ENCRYPTION_OID, StaticResolver
from .sha_utils import sha256

# DigestInfo of SHA-256 (RFC 8017 §9.2, note 1)
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
RSA_E = 65537
_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % d for d in range(2, int(p**0.5) + 1))]


def _is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    """Miller-Rabin with `rounds` random bases (error below 4^-rounds)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, rng: random.Random) -> int:
    """A prime of exactly `bits` bits with its top two bits set (so that the
    product of two has 2 * bits bits) and p - 1 prime to RSA_E."""
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % RSA_E and _is_probable_prime(c, rng):
            return c


def generate_rsa_key(bits: int, seed: int) -> tuple[int, int, int]:
    """(n, e, d) of an RSA key of `bits` bits, a function of `seed` alone."""
    rng = random.Random(seed)
    while True:
        p = _random_prime(bits // 2, rng)
        q = _random_prime(bits - bits // 2, rng)
        if p != q:
            break
    n = p * q
    phi = (p - 1) * (q - 1)
    return n, RSA_E, pow(RSA_E, -1, phi)


def pkcs1v15_sha256_sign(n: int, d: int, message: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 signature of SHA-256(message) (RFC 8017 §8.2.1)."""
    k = (n.bit_length() + 7) // 8
    t = SHA256_DIGEST_INFO + sha256(message)
    em = b"\x00\x01" + b"\xff" * (k - 3 - len(t)) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    if n < 0x80:
        head = bytes([n])
    else:
        nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([0x80 | len(nb)]) + nb
    return bytes([tag]) + head + body


def _der_uint(x: int) -> bytes:
    return _der(0x02, x.to_bytes(x.bit_length() // 8 + 1, "big"))


def rsa_spki_der(n: int, e: int) -> bytes:
    """DER SubjectPublicKeyInfo of the RSA public key (n, e)."""
    alg = _der(0x30, _der(0x06, RSA_ENCRYPTION_OID) + _der(0x05, b""))
    key = _der(0x30, _der_uint(n) + _der_uint(e))
    return _der(0x30, alg + _der(0x03, b"\x00" + key))


@dataclass
class LocalDKIMSigner:
    domain: str = "tpu.example.com"
    selector: str = "tpu2026"
    key_size: int = 2048
    seed: int = 0

    def __post_init__(self):
        n, e, self._d = generate_rsa_key(self.key_size, self.seed)
        self.public_key = (n, e)

    def resolver(self) -> StaticResolver:
        return StaticResolver({(self.domain, self.selector): [self.public_key]})

    def spki_base64(self) -> str:
        return base64.b64encode(rsa_spki_der(*self.public_key)).decode()

    def dns_txt_record(self) -> str:
        return f"v=DKIM1; k=rsa; p={self.spki_base64()}"

    def sign_email(
        self,
        frm: str | None = None,
        to: str = "alice@example.org",
        subject: str = "Hello from the TPU prover",
        body: bytes = b"This is a test body.\r\nIt proves DKIM on TPUs.\r\n",
        canon: str = "relaxed/relaxed",
        extra_headers: list | None = None,
        signed_headers: str = "from:to:subject:date:message-id",
    ) -> bytes:
        frm = frm or f"bob@{self.domain}"
        header_lines = [
            (b"From", frm.encode()),
            (b"To", to.encode()),
            (b"Subject", subject.encode()),
            (b"Date", b"Sun, 17 Aug 2026 12:00:00 +0000"),
            (b"Message-ID", b"<test-12345@" + self.domain.encode() + b">"),
        ] + [(k.encode(), v.encode()) for k, v in (extra_headers or [])]

        body_canon_algo = canon.split("/")[1]
        bh = base64.b64encode(sha256(canon_body(body, body_canon_algo))).decode()

        dkim_value = (
            f" v=1; a=rsa-sha256; c={canon}; d={self.domain}; s={self.selector};"
            f" h={signed_headers}; bh={bh}; b="
        )
        raw_no_sig = (
            b"".join(k + b": " + v + b"\r\n" for k, v in header_lines)
            + b"DKIM-Signature:" + dkim_value.encode() + b"\r\n"
            + b"\r\n" + body
        )
        return _signed_email(
            header_lines, dkim_value, body,
            lambda base: pkcs1v15_sha256_sign(self.public_key[0], self._d, base))


def _signed_email(header_lines: list, dkim_value: str, body: bytes, sign) -> bytes:
    """The email with its DKIM-Signature's b= set to sign(signature base)."""
    head = b"".join(k + b": " + v + b"\r\n" for k, v in header_lines)
    raw_no_sig = head + b"DKIM-Signature:" + dkim_value.encode() + b"\r\n\r\n" + body
    parsed = parse_message(raw_no_sig)
    sig_header_raw = next(raw for (n, raw, v) in parsed.headers if n == "dkim-signature")
    tags = parse_tags(sig_header_raw.split(b":", 1)[1])
    b64sig = base64.b64encode(sign(build_signature_base(parsed, sig_header_raw, tags)))
    return head + b"DKIM-Signature:" + dkim_value.encode() + b64sig + b"\r\n\r\n" + body


@dataclass
class LocalEd25519DKIMSigner:
    """RFC 8463 ed25519-sha256 signer: host verification passes its mail,
    which the circuit cannot prove (results carry circuit_provable=False).
    The secret key is 32 bytes of random.Random(seed)."""

    domain: str = "tpu.example.com"
    selector: str = "tpu2026ed"
    seed: int = 0

    def __post_init__(self):
        self._secret = random.Random(self.seed).randbytes(32)
        self.public_key = ("ed25519", ed25519.public_key(self._secret))

    def resolver(self) -> StaticResolver:
        return StaticResolver({(self.domain, self.selector): [self.public_key]})

    def dns_txt_record(self) -> str:
        return "v=DKIM1; k=ed25519; p=" + base64.b64encode(self.public_key[1]).decode()

    def sign_email(
        self,
        frm: str | None = None,
        to: str = "alice@example.org",
        subject: str = "Hello from the TPU prover",
        body: bytes = b"This is a test body.\r\nIt proves DKIM on TPUs.\r\n",
        canon: str = "relaxed/relaxed",
        signed_headers: str = "from:to:subject:date:message-id",
    ) -> bytes:
        frm = frm or f"bob@{self.domain}"
        header_lines = [
            (b"From", frm.encode()),
            (b"To", to.encode()),
            (b"Subject", subject.encode()),
            (b"Date", b"Sun, 17 Aug 2026 12:00:00 +0000"),
            (b"Message-ID", b"<test-ed-12345@" + self.domain.encode() + b">"),
        ]
        body_canon_algo = canon.split("/")[1]
        bh = base64.b64encode(sha256(canon_body(body, body_canon_algo))).decode()
        dkim_value = (
            f" v=1; a=ed25519-sha256; c={canon}; d={self.domain};"
            f" s={self.selector}; h={signed_headers}; bh={bh}; b="
        )
        # RFC 8463: PureEdDSA over the SHA-256 digest of the signature base
        return _signed_email(header_lines, dkim_value, body,
                             lambda base: ed25519.sign(self._secret, sha256(base)))
