"""RFC 6376 DKIM canonicalization (simple/relaxed, header/body).

From-scratch implementation of the semantics in the reference's vendored
mailauth stack (packages/helpers/src/lib/mailauth/header/{relaxed,simple}.ts,
body/{relaxed,simple}.ts).
"""

from __future__ import annotations

import re

WSP_RUN = re.compile(rb"[ \t]+")


def canon_header_relaxed(name: bytes, value: bytes) -> bytes:
    """relaxed header canonicalization: lowercase name, unfold, collapse WSP,
    trim around the colon."""
    name = name.strip().lower()
    # unfold: remove CRLF that precede WSP
    value = value.replace(b"\r\n", b"").replace(b"\n", b"")
    value = WSP_RUN.sub(b" ", value).strip()
    return name + b":" + value


def canon_header_simple(raw_header_line: bytes) -> bytes:
    """simple: the header line exactly as it appears (without final CRLF)."""
    return raw_header_line.rstrip(b"\r\n")


def strip_b_value(dkim_header_value: bytes) -> bytes:
    """Remove the b= tag's value (keep 'b=') for signature computation —
    mailauth header/relaxed.ts:70-78 semantics, works for simple too."""
    # match b= up to the next ';' or end, tolerating internal folding WSP
    return re.sub(rb"([;:\s]b=)[^;]*", rb"\1", dkim_header_value, count=1)


def canon_body_simple(body: bytes, max_len: int | None = None) -> bytes:
    """simple body: strip trailing empty lines, ensure exactly one final CRLF.

    An empty body canonicalizes to CRLF.
    """
    body = re.sub(rb"(\r\n)+$", b"\r\n", body)
    if not body.endswith(b"\r\n"):
        body += b"\r\n"
    if body == b"\r\n" and max_len is None:
        pass
    if max_len is not None:
        body = body[:max_len]
    return body


def canon_body_relaxed(body: bytes, max_len: int | None = None) -> bytes:
    """relaxed body: per-line strip trailing WSP + collapse WSP runs; drop
    trailing empty lines; final CRLF if body non-empty."""
    if body == b"":
        out = b""
    else:
        # normalize bare LF to CRLF first (mailauth ensureLinebreaks)
        body = re.sub(rb"(?<!\r)\n", b"\r\n", body)
        lines = body.split(b"\r\n")
        lines = [WSP_RUN.sub(b" ", ln.rstrip(b" \t")) for ln in lines]
        out = b"\r\n".join(lines)
        out = re.sub(rb"(\r\n)*$", b"", out)
        if out:
            out += b"\r\n"
    if max_len is not None:
        out = out[:max_len]
    return out


def canon_body(body: bytes, algo: str, max_len: int | None = None) -> bytes:
    if algo == "relaxed":
        return canon_body_relaxed(body, max_len)
    if algo == "simple":
        return canon_body_simple(body, max_len)
    raise ValueError(f"unknown body canonicalization {algo!r}")
