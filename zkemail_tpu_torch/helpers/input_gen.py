"""Witness-input generation: email -> circuit input dict.

The top of the host pipeline, mirroring
zk-email-verify packages/helpers/src/input-generators.ts:
generateEmailVerifierInputs:168 / generateEmailVerifierInputsFromDKIMResult:190,
including the partial-SHA body split, quoted-printable selector adjustment
(:89-158) and soft-line-break decoded body.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .binary_format import to_circom_bigint
from .constants import MAX_BODY_PADDED_BYTES, MAX_HEADER_PADDED_BYTES
from .dkim import DKIMVerificationResult, verify_dkim_signature
from .sha_utils import generate_partial_sha, sha256_pad


@dataclass
class InputGenArgs:
    """Mirror of InputGenerationArgs (input-generators.ts:20-36)."""

    ignore_body_hash_check: bool = False
    enable_header_masking: bool = False
    enable_body_masking: bool = False
    remove_soft_line_breaks: bool = False
    max_headers_length: int = MAX_HEADER_PADDED_BYTES
    max_body_length: int = MAX_BODY_PADDED_BYTES
    sha_precompute_selector: str | None = None
    header_mask: list | None = None
    body_mask: list | None = None


def remove_soft_line_breaks_str(body: list[str]) -> list[str]:
    """Remove quoted-printable '=\r\n' soft line breaks from a char array,
    zero-padding the tail (input-generators.ts:127)."""
    out = []
    i = 0
    n = len(body)
    while i < n:
        if (
            i + 2 < n
            and body[i] == "61"  # '='
            and body[i + 1] == "13"  # \r
            and body[i + 2] == "10"  # \n
        ):
            i += 3
        else:
            out.append(body[i])
            i += 1
    out.extend(["0"] * (n - len(out)))
    return out


def get_adjusted_selector(selector: str, body: bytes) -> str:
    """If the SHA precompute selector is split by QP soft line breaks in the
    body, return the actual (broken) form found in the body
    (input-generators.ts:89 getAdjustedSelector)."""
    pattern = ("(=\r\n)?".join(re.escape(c) for c in selector)).encode()
    m = re.search(pattern, body)
    if not m:
        raise ValueError(f"SHA precompute selector {selector!r} not found in body")
    return m.group(0).decode("latin-1")


def generate_email_verifier_inputs_from_dkim(
    dkim: DKIMVerificationResult, params: InputGenArgs | None = None
) -> dict:
    params = params or InputGenArgs()
    if not dkim.circuit_provable:
        raise ValueError(
            f"DKIM signature verified ({dkim.algo}) but the RSA-65537 "
            "circuit cannot prove it; only rsa-sha256 mail is provable"
        )
    headers, body = dkim.headers, dkim.body

    header_padded, header_padded_len = sha256_pad(headers, params.max_headers_length)
    inputs = {
        "emailHeader": [str(b) for b in header_padded],
        "emailHeaderLength": str(header_padded_len),
        "pubkey": [str(x) for x in to_circom_bigint(dkim.public_key[0])],
        "signature": [str(x) for x in to_circom_bigint(dkim.signature)],
    }
    if params.enable_header_masking:
        if params.header_mask is None:
            raise ValueError("headerMask is required when header masking is on")
        inputs["headerMask"] = [str(int(x)) for x in params.header_mask]

    if not params.ignore_body_hash_check:
        bh_idx = headers.find(dkim.body_hash.encode())
        if bh_idx == -1:
            raise ValueError("body hash not found in signed headers")
        inputs["bodyHashIndex"] = str(bh_idx)

        # pad body to max(maxBodyLength, needed) then split at the selector
        body_sha_length = ((len(body) + 63 + 65) // 64) * 64
        body_padded, body_padded_len = sha256_pad(
            body, max(params.max_body_length, body_sha_length)
        )
        selector = params.sha_precompute_selector
        if selector:
            selector = get_adjusted_selector(selector, body_padded)
        precomputed, body_remaining, body_remaining_len = generate_partial_sha(
            body_padded,
            body_padded_len,
            selector,
            params.max_body_length,
        )
        if body_remaining_len > params.max_body_length:
            raise ValueError(
                "body (after SHA precompute) exceeds maxBodyLength; "
                "increase maxBodyLength or use a later shaPrecomputeSelector"
            )
        inputs["emailBody"] = [str(b) for b in body_remaining]
        inputs["emailBodyLength"] = str(body_remaining_len)
        inputs["precomputedSHA"] = [str(b) for b in precomputed]

        if params.remove_soft_line_breaks:
            inputs["decodedEmailBodyIn"] = remove_soft_line_breaks_str(
                inputs["emailBody"]
            )
        if params.enable_body_masking:
            if params.body_mask is None:
                raise ValueError("bodyMask is required when body masking is on")
            inputs["bodyMask"] = [str(int(x)) for x in params.body_mask]
    return inputs


def generate_email_verifier_inputs(
    raw_email: bytes,
    resolver,
    params: InputGenArgs | None = None,
    domain: str | None = None,
) -> dict:
    """email bytes -> circuit inputs (generateEmailVerifierInputs:168)."""
    dkim = verify_dkim_signature(raw_email, resolver, domain=domain)
    return generate_email_verifier_inputs_from_dkim(dkim, params)
