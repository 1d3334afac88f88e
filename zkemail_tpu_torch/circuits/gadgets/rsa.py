"""RSA-2048 (e = 65537) PKCS#1 v1.5 signature verification constraints.

Parity target: zk-email-verify packages/circuits/lib/rsa.circom —
RSAVerifier65537:13 (range checks + sig < modulus + pow-vs-padded compare),
FpPow65537Mod:57 (16 squarings + final multiply), RSAPad:101 (0x00 01 FF..FF
00 || ASN.1 SHA-256 prefix || digest).

The long-division hints for each FpMul arrive as circuit inputs computed by
`circuits/advice.py::rsa_advice` (the `<--` role of
bigint-func.circom's long_div).
"""

from __future__ import annotations

from ..builder import LC, ConstraintSystem, SignalVec
from .bigint import K_LIMBS, N_BITS, big_less_than, fp_mul, range_check_limbs

ASN1_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")
N_MULS = 17  # 16 squarings + 1 final multiply (e = 65537)


def _pad_constant(modulus_bytes: int = 256) -> int:
    """EM with a zeroed digest slot, as a big integer."""
    ff_count = modulus_bytes - 3 - len(ASN1_SHA256_PREFIX) - 32
    em = b"\x00\x01" + b"\xff" * ff_count + b"\x00" + ASN1_SHA256_PREFIX + b"\x00" * 32
    assert len(em) == modulus_bytes
    return int.from_bytes(em, "big")


def padded_message_lcs(digest_bits: SignalVec, k: int = K_LIMBS) -> list:
    """PKCS#1 v1.5 padded-message limbs as LCs over the digest bit signals.

    digest_bits: (8, 32) word bits LSB-first (word 0 = most significant).
    """
    t_const = _pad_constant()
    mask = (1 << N_BITS) - 1
    t_limbs = [(t_const >> (N_BITS * i)) & mask for i in range(k)]
    lcs = [LC([], t_limbs[i]) for i in range(k)]
    for wi in range(8):
        for j in range(32):
            pos = 32 * (7 - wi) + j  # bit position in the big integer
            limb, off = divmod(pos, N_BITS)
            lcs[limb] = lcs[limb] + digest_bits[wi, j] * (1 << off)
    return lcs


def rsa_verifier_65537(
    cs: ConstraintSystem,
    signature: SignalVec,  # (17,) limb signals
    modulus: SignalVec,  # (17,) limb signals
    digest_bits: SignalVec,  # (8, 32) SHA digest word bits (LSB-first)
    ns: str = "rsa",
):
    """Assert signature^65537 mod modulus == PKCS1v15-pad(digest).

    Registers hint inputs '{ns}/q' (17,17), '{ns}/r' (17,17),
    '{ns}/carries' (17,32) — fill with advice.rsa_advice(sig, n).
    """
    k = K_LIMBS
    range_check_limbs(cs, signature)
    range_check_limbs(cs, modulus)
    lt = big_less_than(cs, signature, modulus)
    cs.enforce_equal(lt.lc(), LC([], 1))

    q = cs.add_input(f"{ns}/q", (N_MULS, k), dtype="fr")
    r = cs.add_input(f"{ns}/r", (N_MULS, k), dtype="fr")
    carries = cs.add_input(f"{ns}/carries", (N_MULS, 2 * k - 2), dtype="fr")

    x = signature
    for i in range(16):
        x = fp_mul(cs, x, x, modulus, q[i], r[i], carries[i])
    final = fp_mul(cs, x, signature, modulus, q[16], r[16], carries[16])

    padded = padded_message_lcs(digest_bits, k)
    for i in range(k):
        cs.enforce_equal(final[i].lc(), padded[i])
    return final
