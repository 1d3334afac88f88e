"""DKIM public keys: the TXT-record parser and the resolvers.

The port of ``zkemail_tpu/helpers/dns.py``: ``parse_dkim_txt`` reads
``k=rsa`` records, whose ``p=`` is a DER SubjectPublicKeyInfo (or a bare
PKCS#1 RSAPublicKey), and ``k=ed25519`` records (RFC 8463: the raw 32-byte
key, or an SPKI wrapping it), with a DER reader of its own in place of the
``cryptography`` package. The resolvers are the JAX package's:
``StaticResolver`` serves keys from a table, ``DoHResolver`` asks two
DNS-over-HTTPS providers and cross-checks them, ``ArchiveResolver`` asks the
ZK Email key archive and ``ChainResolver`` unions several.

A resolver is a callable (domain, selector) -> [key, ...]: (modulus,
exponent) for an RSA key, ("ed25519", raw_32_bytes) for an ed25519 key.
"""

from __future__ import annotations

import base64
import json
import logging
import re
import urllib.request

logger = logging.getLogger(__name__)

DOH_PROVIDERS = [
    "https://dns.google/resolve?name={name}&type=TXT",
    "https://cloudflare-dns.com/dns-query?name={name}&type=TXT",
]
ARCHIVE_URL = "https://archive.prove.email/api/key?domain={domain}"

# rsaEncryption, 1.2.840.113549.1.1.1
RSA_ENCRYPTION_OID = bytes.fromhex("2a864886f70d010101")
# id-Ed25519, 1.3.101.112 (RFC 8410)
ED25519_OID = bytes.fromhex("2b6570")


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


def ed25519_raw_key(blob: bytes) -> bytes:
    """The raw 32-byte Ed25519 public key of p= material: the key itself
    (RFC 8463), or a DER SubjectPublicKeyInfo of id-Ed25519 around it."""
    if len(blob) == 32:
        return blob
    tag, body, end = _der_read(blob, 0)
    if tag != 0x30 or end != len(blob):
        raise ValueError("expected one DER SEQUENCE")
    items = _der_seq(body)
    if len(items) != 2 or items[0][0] != 0x30 or items[1][0] != 0x03:
        raise ValueError("not a SubjectPublicKeyInfo")
    if _der_seq(items[0][1]) != [(0x06, ED25519_OID)]:
        raise ValueError("k=ed25519 but the key material is not an Ed25519 key")
    bits = items[1][1]
    if len(bits) != 33 or bits[0] != 0:
        raise ValueError("bad Ed25519 key BIT STRING")
    return bits[1:]


def parse_dkim_txt(txt: str, strict: bool = False):
    """Parse a DKIM TXT record ``v=DKIM1; k=rsa; p=<base64 DER>``.

    RSA records give (n, e); ed25519 records give ("ed25519", raw_32_bytes).
    strict=True raises the JAX package's key-record errors (EINVALIDVAL:
    missing or undecodable p=, EINVALIDVER: v= present and not DKIM1,
    EINVALIDTYPE: k= neither rsa nor ed25519) instead of returning None."""
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
    if ktype not in ("rsa", "ed25519"):
        return fail("EINVALIDTYPE", f"unknown key type {ktype!r}")
    p = tags.get("p", "")
    if not p:
        return fail("EINVALIDVAL", "missing key value")
    try:
        der = base64.b64decode(re.sub(r"\s+", "", p) + "==")
        if ktype == "ed25519":
            return ("ed25519", ed25519_raw_key(der))
        return rsa_from_der(der)
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


class DoHResolver:
    """Resolve over DNS-over-HTTPS (needs network egress).

    The JAX package's dual-provider semantics: each provider is queried
    (with per-provider retries) and providers that both answer are
    cross-checked. On a mismatch the first provider's record is kept and a
    warning logged; the ordered union across agreeing providers is returned
    otherwise. ``union_on_mismatch=True`` unions even mismatched answers.
    """

    def __init__(self, providers=None, timeout: float = 10.0, retries: int = 1,
                 union_on_mismatch: bool = False):
        self.providers = providers or DOH_PROVIDERS
        self.timeout = timeout
        self.retries = retries  # extra attempts after the first
        self.union_on_mismatch = union_on_mismatch
        self._last_key_error = None

    def _query(self, tmpl: str, name: str) -> list | None:
        """One provider, with `retries` retries after the first attempt.
        None = provider unreachable."""
        last = None
        for _ in range(1 + max(0, self.retries)):
            try:
                req = urllib.request.Request(
                    tmpl.format(name=name), headers={"accept": "application/dns-json"}
                )
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    data = json.loads(resp.read())
                keys = []
                for ans in data.get("Answer", []) or []:
                    # a strict parse: remember the key-record error but keep
                    # trying the other records (rotation sets mix good and bad)
                    try:
                        parsed = parse_dkim_txt(ans.get("data", ""), strict=True)
                    except Exception as exc:
                        self._last_key_error = exc
                        parsed = None
                    if parsed:
                        keys.append(parsed)
                return keys
            except Exception as exc:  # noqa: BLE001 — provider fallback by design
                last = exc
        logger.debug("DoH provider %s failed after retries: %s", tmpl, last)
        return None

    def __call__(self, domain: str, selector: str):
        name = f"{selector}._domainkey.{domain}"
        self._last_key_error = None
        per_provider = [(t, self._query(t, name)) for t in self.providers]
        answered = [(t, ks) for t, ks in per_provider if ks is not None]
        mismatch = any(
            set(answered[i][1]) != set(answered[j][1])
            for i in range(len(answered))
            for j in range(i + 1, len(answered))
        )
        if mismatch:
            logger.warning(
                "DoH cross-check mismatch for %s across %s%s",
                name,
                [t for t, _ in answered],
                "" if self.union_on_mismatch else "; using first provider only",
            )
            if not self.union_on_mismatch:
                answered = answered[:1]
        keys, seen = [], set()
        for _, ks in answered:
            for k in ks:
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        if not keys and self._last_key_error is not None:
            # records existed but none parsed to a usable key
            raise self._last_key_error
        return keys


class ArchiveResolver:
    """The ZK Email key archive, for rotated keys."""

    def __init__(self, url: str = ARCHIVE_URL, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout

    def __call__(self, domain: str, selector: str):
        try:
            with urllib.request.urlopen(
                self.url.format(domain=domain), timeout=self.timeout
            ) as resp:
                entries = json.loads(resp.read())
        except Exception:
            return []
        keys, key_err = [], None
        for entry in entries:
            if entry.get("selector") != selector:
                continue
            try:
                parsed = parse_dkim_txt(entry.get("value", ""), strict=True)
            except Exception as exc:
                key_err = exc
                parsed = None
            if parsed:
                keys.append(parsed)
        if not keys and key_err is not None:
            raise key_err
        return keys


class ChainResolver:
    """Union of resolvers, in order; a resolver's key-record error is kept
    and raised only when no resolver gives a key."""

    def __init__(self, *resolvers):
        self.resolvers = resolvers

    def __call__(self, domain: str, selector: str):
        keys, seen = [], set()
        key_err = None
        for r in self.resolvers:
            try:
                found = r(domain, selector)
            except Exception as exc:
                key_err = exc
                continue
            for k in found:
                if k not in seen:
                    seen.add(k)
                    keys.append(k)
        if not keys and key_err is not None:
            raise key_err
        return keys
