"""DKIM public keys: the TXT-record parser and the hermetic resolver.

The port of ``zkemail_tpu/helpers/dns.py``, RSA only: ``parse_dkim_txt``
reads ``k=rsa`` records, whose ``p=`` is a DER SubjectPublicKeyInfo (or a
bare PKCS#1 RSAPublicKey), with a DER reader of its own, and
``StaticResolver`` serves keys from a table. The DNS-over-HTTPS, archive and
chain resolvers, and ed25519 keys, are not ported: the circuit proves RSA
signatures only.

A resolver is a callable (domain, selector) -> [(modulus, exponent), ...].
"""

from __future__ import annotations

import base64
import re

# rsaEncryption, 1.2.840.113549.1.1.1
RSA_ENCRYPTION_OID = bytes.fromhex("2a864886f70d010101")


def _der_read(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """One DER element at buf[pos:] -> (tag, contents, position after it).

    Strict DER, as ``cryptography`` reads a key: the length takes the short
    form below 128 and otherwise the fewest bytes of the long form."""
    if pos + 2 > len(buf):
        raise ValueError("truncated DER element")
    tag, n = buf[pos], buf[pos + 1]
    pos += 2
    if n & 0x80:
        k = n & 0x7F
        if k == 0 or k > 4 or pos + k > len(buf):
            raise ValueError("bad DER length")
        n = int.from_bytes(buf[pos : pos + k], "big")
        if n < 0x80 or buf[pos] == 0:
            raise ValueError("non-minimal DER length")
        pos += k
    if pos + n > len(buf):
        raise ValueError("truncated DER element")
    return tag, buf[pos : pos + n], pos + n


def _der_seq(buf: bytes) -> list[tuple[int, bytes]]:
    """The (tag, contents) elements of a DER SEQUENCE's contents."""
    out, pos = [], 0
    while pos < len(buf):
        tag, body, pos = _der_read(buf, pos)
        out.append((tag, body))
    return out


def _der_uint(tag: int, body: bytes) -> int:
    """A non-negative DER INTEGER in its minimal encoding."""
    if tag != 0x02 or not body:
        raise ValueError("expected a DER INTEGER")
    if len(body) > 1 and (body[0] == 0 and body[1] < 0x80
                          or body[0] == 0xFF and body[1] >= 0x80):
        raise ValueError("non-minimal DER INTEGER")
    if body[0] & 0x80:
        raise ValueError("negative RSA key component")
    return int.from_bytes(body, "big")


def rsa_from_der(der: bytes) -> tuple[int, int]:
    """(n, e) from a DER SubjectPublicKeyInfo or PKCS#1 RSAPublicKey."""
    tag, body, end = _der_read(der, 0)
    if tag != 0x30 or end != len(der):
        raise ValueError("expected one DER SEQUENCE")
    items = _der_seq(body)
    if len(items) == 2 and items[0][0] == 0x02:  # RSAPublicKey
        return _der_uint(*items[0]), _der_uint(*items[1])
    if len(items) != 2 or items[0][0] != 0x30 or items[1][0] != 0x03:
        raise ValueError("not a SubjectPublicKeyInfo")
    alg = _der_seq(items[0][1])
    if not alg or alg[0] != (0x06, RSA_ENCRYPTION_OID):
        from .dkim import DKIMError

        raise DKIMError("EINVALIDTYPE", "not an RSA key (circuit proves rsa only)")
    bits = items[1][1]
    if not bits or bits[0] != 0:
        raise ValueError("bad BIT STRING")
    return rsa_from_der(bits[1:])


def parse_dkim_txt(txt: str, strict: bool = False):
    """Parse a DKIM TXT record ``v=DKIM1; k=rsa; p=<base64 DER>`` -> (n, e).

    strict=True raises the JAX package's key-record errors (EINVALIDVAL:
    missing or undecodable p=, EINVALIDVER: v= present and not DKIM1,
    EINVALIDTYPE: k= not rsa) instead of returning None. ``k=ed25519``
    records are refused as EINVALIDTYPE: ed25519 keys are not ported."""
    from .dkim import DKIMError

    def fail(code, msg):
        if strict:
            raise DKIMError(code, msg)
        return None

    txt = txt.strip().strip('"').replace('" "', "").replace('""', "")
    tags = {}
    for part in txt.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            tags[k.strip().lower()] = v.strip()
    if "v" in tags and tags["v"].strip().lower() != "dkim1":
        return fail("EINVALIDVER", f"unknown key version {tags['v']!r}")
    ktype = tags.get("k", "rsa").strip().lower()
    if ktype != "rsa":
        return fail("EINVALIDTYPE", f"unsupported key type {ktype!r} (rsa only)")
    p = tags.get("p", "")
    if not p:
        return fail("EINVALIDVAL", "missing key value")
    try:
        return rsa_from_der(base64.b64decode(re.sub(r"\s+", "", p) + "=="))
    except DKIMError:
        raise
    except ValueError as exc:  # bad base64 / DER
        return fail("EINVALIDVAL", f"invalid public key: {exc}")


class StaticResolver:
    """Hermetic resolver for tests / air-gapped runs: {(domain, selector): [keys]}"""

    def __init__(self, table: dict):
        self.table = {
            (d.lower(), s.lower()): v if isinstance(v, list) else [v]
            for (d, s), v in table.items()
        }

    def __call__(self, domain: str, selector: str):
        return self.table.get((domain.lower(), selector.lower()), [])
