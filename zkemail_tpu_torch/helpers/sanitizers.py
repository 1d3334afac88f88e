"""Email sanitization-retry transforms for forwarded/mangled emails.

Semantics of zk-email-verify packages/helpers/src/dkim/sanitizers.ts:
applied in parallel by the verifier when the raw email fails signature
verification (dkim/index.ts:49-66). A copy of the JAX package's module, so
that the port imports nothing of it.
"""

from __future__ import annotations

import re


def revert_google_message_id(email: bytes) -> bytes | None:
    """Gmail forwards rewrite Message-ID to X-Google-Original-Message-ID."""
    if b"X-Google-Original-Message-ID" not in email:
        return None
    m = re.search(rb"X-Google-Original-Message-ID:\s*([^\r\n]+)", email)
    if not m:
        return None
    orig = m.group(1).strip()
    return re.sub(rb"(?mi)^Message-ID:\s*[^\r\n]+", b"Message-ID: " + orig, email, count=1)


def remove_labels(email: bytes) -> bytes | None:
    """Strip mailing-list style "[label] " prefixes from the Subject."""
    out = re.sub(rb"(?mi)^(Subject:\s*)\[[^\]]*\]\s?", rb"\1", email, count=1)
    return out if out != email else None


def insert_13_before_10(email: bytes) -> bytes | None:
    """Restore CRLF line endings for emails saved with bare LF."""
    out = re.sub(rb"(?<!\r)\n", b"\r\n", email)
    return out if out != email else None


def sanitize_tabs(email: bytes) -> bytes | None:
    """Replace quoted-printable '=09' with a literal tab."""
    if b"=09" not in email:
        return None
    return email.replace(b"=09", b"\t")


SANITIZERS = [revert_google_message_id, remove_labels, insert_13_before_10, sanitize_tabs]
