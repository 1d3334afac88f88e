"""DKIM (RFC 6376) verification on the host.

The port of ``zkemail_tpu/helpers/dkim.py``: parse -> canonicalize ->
body-hash check -> signature base reconstruction -> RSA-SHA256 or RFC 8463
ed25519-sha256 verify with multi-key trial, returning the byte buffers that
feed the circuit inputs, with the JAX package's sanitizer retries and
Authentication-Results row. Both verifications are Python integer
arithmetic (``helpers/ed25519.py`` for ed25519). The circuit proves RSA
only, so ed25519 results carry ``circuit_provable=False``.
"""

from __future__ import annotations

import base64
import re
from dataclasses import dataclass, field

from . import ed25519
from .canon import (
    canon_body,
    canon_header_relaxed,
    canon_header_simple,
    strip_b_value,
)
from .sha_utils import sha256

# ---------------------------------------------------------------------------
# Message parsing
# ---------------------------------------------------------------------------


@dataclass
class ParsedMessage:
    headers: list  # list of (lower_name: str, raw_line: bytes incl. folds, value: bytes)
    body: bytes


def parse_message(raw: bytes) -> ParsedMessage:
    raw = re.sub(rb"(?<!\r)\n", b"\r\n", raw)  # normalize bare LF (mailauth ensureLinebreaks)
    if b"\r\n\r\n" in raw:
        head, body = raw.split(b"\r\n\r\n", 1)
    else:
        head, body = raw, b""
    lines = head.split(b"\r\n")
    headers = []
    cur = None
    for ln in lines:
        if ln[:1] in (b" ", b"\t") and cur is not None:
            cur = cur + b"\r\n" + ln
            headers[-1] = (headers[-1][0], cur)
            continue
        cur = ln
        name = ln.split(b":", 1)[0].strip().lower().decode("latin-1") if b":" in ln else ""
        headers.append((name, cur))
    out = []
    for name, raw_line in headers:
        value = raw_line.split(b":", 1)[1] if b":" in raw_line else b""
        out.append((name, raw_line, value))
    return ParsedMessage(out, body)


# ---------------------------------------------------------------------------
# DKIM-Signature tag list parsing (parse-dkim-headers.ts equivalent)
# ---------------------------------------------------------------------------

def parse_tags_full(value: bytes) -> list[dict]:
    """Tag-list state machine (parse-dkim-headers.ts headerParser:146-260).

    Character-level states key/value/comment/quoted: `;` splits parts only
    at the top level (a `;` inside a quoted section or RFC 5322 comment is
    literal), `(...)` comments are captured separately from the value,
    backslash escapes the next character, and folded/FWS whitespace inside
    values collapses to single spaces. Returns the raw parts
    [{key, value, comment, has_value}] in order; empty-key parts dropped and
    per-key whitespace policy applied (b/bh/p/h strip ALL whitespace, like
    the reference's parts[i].value.replace(/\\s+/g, '')).
    """
    line = re.sub(rb"\r\n", b"", value).decode("latin-1")
    parts: list[dict] = []

    def new_part():
        p = {"key": "", "value": "", "comment": "", "has_value": False}
        parts.append(p)
        return p

    state = "key"
    last_state = "key"
    quote = ""
    escaped = False
    cur = new_part()
    for c in line:
        if state in ("key", "value"):
            if state == "key" and c == "=" and not escaped:
                state = "value"
                cur["has_value"] = True
                continue
            if escaped:
                cur[state] += c
                escaped = False
            elif c == ";":
                cur = new_part()
                state = "key"
            elif c == "\\":
                escaped = True
            elif c == "(":
                last_state = state
                state = "comment"
            elif c in "\"'":
                last_state = state
                state = "quoted"
                quote = c
            else:
                cur[state] += c
        elif state == "comment":
            if escaped:
                cur["comment"] += c
                escaped = False
            elif c == "\\":
                escaped = True
            elif c == ")":
                state = last_state
            else:
                cur["comment"] += c
        elif state == "quoted":
            if escaped:
                cur[last_state] += c
                escaped = False
            elif c == "\\":
                escaped = True
            elif c == quote:
                state = last_state
            else:
                cur[last_state] += c

    out = []
    for p in parts:
        p["key"] = re.sub(r"\s+", " ", p["key"]).strip().lower()
        if not p["key"]:
            continue
        if p["key"] in ("bh", "b", "p", "h"):
            p["value"] = re.sub(r"\s+", "", p["value"])
        else:
            p["value"] = re.sub(r"\s+", " ", p["value"]).strip()
        p["comment"] = re.sub(r"\s+", " ", p["comment"]).strip()
        out.append(p)
    return out


def parse_tags(value: bytes) -> dict[str, str]:
    """{tag: value} view of parse_tags_full (later duplicates win, matching
    the reference's result[part.key] overwrite)."""
    return {p["key"]: p["value"] for p in parse_tags_full(value)}


# ---------------------------------------------------------------------------
# Result container (mirrors DKIMVerificationResult, dkim/index.ts:12-24)
# ---------------------------------------------------------------------------


@dataclass
class DKIMVerificationResult:
    signature: int
    public_key: tuple  # (n, e) for RSA; ("ed25519", raw_32_bytes) otherwise
    headers: bytes  # canonicalized signed-header buffer (circuit input)
    body: bytes  # canonicalized body (circuit input)
    body_hash: str  # base64 bh= tag
    signing_domain: str
    selector: str
    algo: str
    format: str  # canonicalization c= tag
    modulus_length: int
    applied_sanitization: str | None = None
    status: dict = field(default_factory=dict)
    auth_results: str | None = None  # Authentication-Results row (tools.ts:416)
    # rsa-sha256 and ed25519-sha256 both verify on the host; only rsa-sha256
    # signatures can feed the RSA-65537 circuit
    circuit_provable: bool = True


class DKIMError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


# ---------------------------------------------------------------------------
# Core verification
# ---------------------------------------------------------------------------

def _signed_header_lines(parsed: ParsedMessage, h_tag: str, sig_index: int):
    """Select headers per h= (bottom-up, last occurrence first per RFC 6376
    §5.4.2 — tools.ts:107 getSigningHeaderLines semantics)."""
    wanted = [x.strip().lower() for x in h_tag.split(":") if x.strip()]
    cursors: dict[str, int] = {}
    selected = []
    for name in wanted:
        start = cursors.get(name, len(parsed.headers))
        idx = -1
        for i in range(start - 1, -1, -1):
            if parsed.headers[i][0] == name:
                idx = i
                break
        if idx == -1:
            continue  # missing header contributes nothing
        cursors[name] = idx
        selected.append(parsed.headers[idx])
    return selected


def compute_body_hash(body: bytes, canon_algo: str, length: int | None) -> bytes:
    canon = canon_body(body, canon_algo, length)
    return sha256(canon)


def build_signature_base(
    parsed: ParsedMessage, sig_header_raw: bytes, tags: dict
) -> bytes:
    header_canon = tags.get("c", "simple/simple").split("/")[0]
    selected = _signed_header_lines(parsed, tags.get("h", ""), 0)
    chunks = []
    for name, raw_line, value in selected:
        if header_canon == "relaxed":
            chunks.append(canon_header_relaxed(name.encode(), value))
        else:
            chunks.append(canon_header_simple(raw_line))
    # the DKIM-Signature header itself, b= value stripped, no trailing CRLF
    stripped = strip_b_value(sig_header_raw)
    if header_canon == "relaxed":
        nm, val = stripped.split(b":", 1)
        chunks.append(canon_header_relaxed(nm, val))
    else:
        chunks.append(canon_header_simple(stripped))
    return b"\r\n".join(chunks)


def ed25519_sha256_verify(pub_raw: bytes, sig: bytes, message: bytes) -> bool:
    """RFC 8463 ed25519-sha256: PureEdDSA over the SHA-256 digest of the
    canonicalized signature base."""
    return ed25519.verify(pub_raw, sha256(message), sig)


def rsa_sha256_verify(n: int, e: int, signature: int, message: bytes) -> bool:
    """PKCS#1 v1.5 RSA-SHA256 verification by direct modular exponentiation."""
    k = (n.bit_length() + 7) // 8
    if not 0 < signature < n:
        return False
    em = pow(signature, e, n).to_bytes(k, "big")
    digest = sha256(message)
    # 0x00 0x01 FF..FF 0x00 || ASN.1 DigestInfo(SHA-256) || digest
    prefix = bytes.fromhex("3031300d060960864801650304020105000420")
    expected = b"\x00\x01" + b"\xff" * (k - 3 - len(prefix) - 32) + b"\x00" + prefix + digest
    return em == expected


def verify_dkim_signature(
    raw_email: bytes,
    resolver,
    domain: str | None = None,
    enable_sanitization: bool = True,
    fall_back_to_maybe_expired_keys: bool = False,
    skip_body_hash: bool = False,
) -> DKIMVerificationResult:
    """Full DKIM verification. resolver: (domain, selector) -> [(n, e), ...].

    When `domain` is not given it defaults to the From: address domain, and
    only signatures whose d= matches are considered (dkim/index.ts:141-147) —
    a signature by an unrelated domain must not authenticate the mail.
    `skip_body_hash` mirrors the reference's skipBodyHashCheck arg (bodyless
    emails, dkim.test.ts "should skip body-hash verification").
    `fall_back_to_maybe_expired_keys` is accepted and not read, as in the
    JAX package.

    On signature failure, retries the email sanitizers
    (packages/helpers/src/dkim/sanitizers.ts:65) before giving up; the
    error raised is the unsanitized attempt's.
    """
    from .sanitizers import SANITIZERS
    from .tools import format_auth_header_row, get_alignment

    if not domain:
        domain = extract_from_domain(raw_email)
        if not domain:
            raise DKIMError("ENOFROM", "could not determine From: domain")

    attempts = [(None, raw_email)]
    if enable_sanitization:
        attempts += [(s.__name__, s(raw_email)) for s in SANITIZERS]
    last_err: Exception | None = None
    for name, candidate in attempts:
        if candidate is None:
            continue
        try:
            res = _try_verify(candidate, resolver, domain, skip_body_hash)
        except DKIMError as exc:
            if last_err is None or name is None:
                last_err = exc
            continue
        res.applied_sanitization = name
        res.status["aligned"] = get_alignment(domain, [res.signing_domain])
        res.status.setdefault(
            "header", {"i": f"@{res.signing_domain}", "s": res.selector, "a": res.algo})
        res.auth_results = format_auth_header_row("dkim", res.status)
        return res
    raise last_err if last_err else DKIMError("ENOSIG", "no DKIM signature found")


def _try_verify(
    raw_email: bytes, resolver, domain: str | None, skip_body_hash: bool = False
) -> DKIMVerificationResult:
    parsed = parse_message(raw_email)
    sigs = [
        (name, raw_line, value)
        for (name, raw_line, value) in parsed.headers
        if name == "dkim-signature"
    ]
    if not sigs:
        raise DKIMError("ENOSIG", "message does not contain a DKIM signature")
    errors = []
    for name, raw_line, value in sigs:
        tags = parse_tags(value)
        d = tags.get("d", "")
        if domain and d.lower() != domain.lower():
            continue
        try:
            return _verify_one(parsed, raw_line, tags, resolver, skip_body_hash)
        except DKIMError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    raise DKIMError("ENOSIG", f"no DKIM signature for domain {domain}")


def _verify_one(
    parsed, sig_header_raw, tags, resolver, skip_body_hash: bool = False
) -> DKIMVerificationResult:
    # v=1 is the only defined DKIM-Signature version (RFC 6376 §3.5); the
    # reference surfaces unknown versions as EINVALIDVER
    # (dkim-verifier.ts:325, mirrored from the key-record check)
    if "v" in tags and tags["v"].strip() != "1":
        raise DKIMError("EINVALIDVER", f"unknown signature version {tags['v']!r}")
    algo = tags.get("a", "rsa-sha256")
    from .tools import validate_algorithm

    try:
        validate_algorithm(algo)
    except ValueError as exc:
        raise DKIMError("EINVALIDALGO", str(exc)) from exc
    # case-sensitive, as the JAX package: a= is a lower-case token
    if algo not in ("rsa-sha256", "ed25519-sha256"):
        raise DKIMError("EINVALIDALGO", f"unsupported algorithm {algo}")
    canon = tags.get("c", "simple/simple")
    parts = canon.split("/")
    header_canon = parts[0] or "simple"
    body_canon = parts[1] if len(parts) > 1 else "simple"
    length = int(tags["l"]) if "l" in tags else None

    bh_expected = tags.get("bh", "")
    body_canonical = canon_body(parsed.body, body_canon, length)
    bh_actual = base64.b64encode(sha256(body_canonical)).decode()
    if bh_actual != bh_expected and not skip_body_hash:
        raise DKIMError("EBODYHASH", "body hash did not verify")

    base = build_signature_base(parsed, sig_header_raw, tags)
    sig_b64 = re.sub(r"\s+", "", tags.get("b", ""))
    signature = int.from_bytes(base64.b64decode(sig_b64 + "=" * (-len(sig_b64) % 4)), "big")

    d, s = tags.get("d", ""), tags.get("s", "")
    keys = resolver(d, s)
    if not keys:
        raise DKIMError("ENODATA", f"no DKIM key found for {s}._domainkey.{d}")

    def result(public_key, modulus_length, provable):
        return DKIMVerificationResult(
            signature=signature,
            public_key=public_key,
            headers=base,
            body=body_canonical,
            body_hash=bh_expected,
            signing_domain=d,
            selector=s,
            algo=algo,
            format=canon,
            modulus_length=modulus_length,
            status={"result": "pass", "aligned": d},
            circuit_provable=provable,
        )

    if algo == "ed25519-sha256":
        sig_bytes = base64.b64decode(sig_b64 + "=" * (-len(sig_b64) % 4))
        for key in keys:
            if key[0] != "ed25519":
                continue  # key-type/algorithm mismatch: try the next key
            if ed25519_sha256_verify(key[1], sig_bytes, base):
                # valid mail, but the RSA-65537 circuit cannot prove it
                return result(key, 256, provable=False)
        raise DKIMError("EBADSIG", "bad signature")

    for key in keys:
        if isinstance(key[0], str):
            continue  # an ed25519 key cannot check an rsa-sha256 signature
        n, e = key
        if n.bit_length() < 1024:
            raise DKIMError("ESHORTKEY", "key too short")
        if rsa_sha256_verify(n, e, signature, base):
            return result((n, e), n.bit_length(), provable=True)
    raise DKIMError("EBADSIG", "bad signature")


def extract_from_domain(raw_email: bytes) -> str | None:
    """Default signing domain from the From: header (dkim/index.ts:141-147)."""
    parsed = parse_message(raw_email)
    for name, _raw, value in parsed.headers:
        if name == "from":
            m = re.search(rb"@([A-Za-z0-9.-]+)", value)
            if m:
                return m.group(1).decode().strip().strip(">").lower()
    return None
