"""EmailVerifier — the flagship circuit.

Parity target: zk-email-verify packages/circuits/email-verifier.circom:42
EmailVerifier(maxHeadersLength, maxBodyLength, n, k, ignoreBodyHashCheck,
enableHeaderMasking, enableBodyMasking, removeSoftLineBreaks), with the same
input/output surface as the reference (inputs named after CircuitInput,
packages/helpers/src/input-generators.ts:6-19) plus the RSA advice inputs.

Public outputs (in order): pubkeyHash, shaHi, shaLo, then optional
maskedHeader / decodedEmailBodyIn / maskedBody.

The port of ``zkemail_tpu/models/email_verifier.py``: the same circuit, row
for row, for every flag.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..circuits.builder import LC, ConstraintSystem, SignalVec
from ..circuits.gadgets.arrays import assert_zero_padding
from ..circuits.gadgets.base64 import base64_decode
from ..circuits.gadgets.bytes import byte_mask
from ..circuits.gadgets.email_helpers import remove_soft_line_breaks
from ..circuits.gadgets.poseidon_gadget import poseidon_large
from ..circuits.gadgets.regex import select_regex_reveal
from ..circuits.gadgets.regex_dfa import dfa_match_gadget
from ..circuits.regex_compiler import (
    BODY_HASH_ANCHORED_PATTERN,
    BODY_HASH_REVEAL_GROUP,
    compile_regex,
    dfa_state_after,
)
from ..circuits.gadgets.rsa import rsa_verifier_65537
from ..circuits.gadgets.sha_wrappers import (
    pack_digest_hi_lo,
    sha256_bytes,
    sha256_bytes_partial,
)


@dataclass(frozen=True)
class EmailVerifierConfig:
    """The 8 compile-time flags of the reference EmailVerifier
    (email-verifier.circom:42-46): maxHeadersLength/maxBodyLength must be
    multiples of 64; limb shape fixed at n=121, k=17."""

    max_headers_length: int = 1024
    max_body_length: int = 1536
    ignore_body_hash_check: bool = False
    enable_header_masking: bool = False
    enable_body_masking: bool = False
    remove_soft_line_breaks: bool = False

    def __post_init__(self):
        assert self.max_headers_length % 64 == 0
        assert self.max_body_length % 64 == 0


@dataclass
class EmailVerifierHandles:
    cs: ConstraintSystem
    config: EmailVerifierConfig
    pubkey_hash: SignalVec
    sha_hi: SignalVec
    sha_lo: SignalVec
    header_digest_bits: SignalVec
    body_digest_bits: SignalVec | None = None
    masked_header: SignalVec | None = None
    masked_body: SignalVec | None = None


def build_email_verifier(cfg: EmailVerifierConfig) -> EmailVerifierHandles:
    cs = ConstraintSystem("email_verifier")

    header = cs.add_input("emailHeader", (cfg.max_headers_length,))
    header_len = cs.add_input("emailHeaderLength", ())
    pubkey = cs.add_input("pubkey", (17,), dtype="fr")
    signature = cs.add_input("signature", (17,), dtype="fr")

    # header bytes beyond the padded length must be zero (email-verifier.circom:63)
    assert_zero_padding(cs, header, header_len)

    # header hash (email-verifier.circom:67, ~506k constraints in reference)
    with cs.scope("sha256_header"):
        header_digest, _sha = sha256_bytes(cs, header, header_len)
        sha_hi, sha_lo = pack_digest_hi_lo(cs, header_digest)

    # RSA-SHA256 signature check (email-verifier.circom:87-95)
    with cs.scope("rsa_verify"):
        rsa_verifier_65537(cs, signature, pubkey, header_digest, ns="rsa")

    # pubkey commitment (email-verifier.circom:173)
    with cs.scope("pubkey_poseidon"):
        pk_hash = poseidon_large(cs, pubkey)

    # public outputs first-class: order matches reference main component
    cs.mark_public(pk_hash)
    cs.mark_public(sha_hi)
    cs.mark_public(sha_lo)

    handles = EmailVerifierHandles(
        cs=cs,
        config=cfg,
        pubkey_hash=pk_hash,
        sha_hi=sha_hi,
        sha_lo=sha_lo,
        header_digest_bits=header_digest,
    )

    if cfg.enable_header_masking:
        mask = cs.add_input("headerMask", (cfg.max_headers_length,))
        masked = byte_mask(cs, header, mask)
        cs.mark_public(masked)
        handles.masked_header = masked

    if not cfg.ignore_body_hash_check:
        body = cs.add_input("emailBody", (cfg.max_body_length,))
        body_len = cs.add_input("emailBodyLength", ())
        bh_index = cs.add_input("bodyHashIndex", ())
        midstate = cs.add_input("precomputedSHA", (32,))

        # DFA-extract the bh= tag from the DKIM-Signature header structure
        # (the zk-regex BodyHashRegex role, email-verifier.circom:124-131):
        # the in-circuit scan anchors the reveal to a line-start
        # `dkim-signature:` tag list, so a decoy `bh=...;` elsewhere in the
        # signed header (e.g. in an attacker-chosen Subject) never marks
        # reveal bytes and cannot be bound to the body check.
        with cs.scope("body_hash_regex"):
            dfa = compile_regex(
                BODY_HASH_ANCHORED_PATTERN,
                reveal_groups={BODY_HASH_REVEAL_GROUP},
                anchored=False,
            )
            is_match, reveal = dfa_match_gadget(
                cs,
                header,
                dfa,
                reveal_tags=[BODY_HASH_REVEAL_GROUP],
                initial_state=dfa_state_after(dfa, b"\r\n"),
                bytes_checked=True,  # sha256_bytes range-checks the header bytes
            )
            cs.enforce_equal(is_match.lc(), LC([], 1))
            bh_chars = select_regex_reveal(
                cs, SignalVec(reveal.idx[0]), bh_index, 44
            )
        with cs.scope("base64_decode"):
            bh_decoded = base64_decode(cs, bh_chars, 32)

        with cs.scope("sha256_body"):
            assert_zero_padding(cs, body, body_len)
            body_digest, _ = sha256_bytes_partial(cs, body, body_len, midstate)
        handles.body_digest_bits = body_digest

        # byte-wise equality digest == decoded bh (email-verifier.circom:139-146)
        for b in range(32):
            wi, pos = divmod(b, 4)
            byte_lc = LC([], 0)
            for j in range(8):
                byte_lc = byte_lc + body_digest[wi, (3 - pos) * 8 + j] * (1 << j)
            cs.enforce_equal(byte_lc, bh_decoded[b].lc())

        if cfg.remove_soft_line_breaks:
            decoded_in = cs.add_input("decodedEmailBodyIn", (cfg.max_body_length,))
            with cs.scope("remove_soft_line_breaks"):
                remove_soft_line_breaks(cs, body, decoded_in)
            cs.mark_public(decoded_in)

        if cfg.enable_body_masking:
            bmask = cs.add_input("bodyMask", (cfg.max_body_length,))
            masked_b = byte_mask(cs, body, bmask)
            cs.mark_public(masked_b)
            handles.masked_body = masked_b

    return handles
