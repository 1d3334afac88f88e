"""Decoder for arkworks compressed BN254 points (the reference rust-verifier's
wire format, packages/rust-verifier/src/main.rs:81-104).

Compressed short-Weierstrass encoding (ark-serialize 0.4):
  * G1: 32 bytes little-endian x; top two bits of the final byte are flags.
  * G2: c0 then c1 of x (32 bytes LE each); flags on the final byte of c1.
  * flags: 0b0100_0000 = point at infinity; 0b1000_0000 = y is the
    lexicographically largest root.

A copy of ``zkemail_tpu/utils/ark_serialize.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from ..core.field import Q
from ..core.towers import Fq2
from ..core.curve import B_G1, B_G2, G1, G2

INF_FLAG = 0x40
Y_LARGEST_FLAG = 0x80


def _sqrt_fq(a: int) -> int | None:
    # q = 3 mod 4
    r = pow(a, (Q + 1) // 4, Q)
    return r if r * r % Q == a % Q else None


def decode_g1(data: bytes) -> G1:
    assert len(data) == 32
    raw = bytearray(data)
    flags = raw[31] & 0xC0
    raw[31] &= 0x3F
    x = int.from_bytes(bytes(raw), "little")
    if flags & INF_FLAG:
        return G1.identity()
    y = _sqrt_fq((x * x * x + B_G1) % Q)
    if y is None:
        raise ValueError("x not on curve")
    y_neg = Q - y
    largest, smallest = max(y, y_neg), min(y, y_neg)
    y = largest if (flags & Y_LARGEST_FLAG) else smallest
    pt = G1(x, y)
    assert pt.on_curve()
    return pt


def decode_g2(data: bytes) -> G2:
    assert len(data) == 64
    raw = bytearray(data)
    flags = raw[63] & 0xC0
    raw[63] &= 0x3F
    c0 = int.from_bytes(bytes(raw[:32]), "little")
    c1 = int.from_bytes(bytes(raw[32:]), "little")
    if flags & INF_FLAG:
        return G2.identity()
    x = Fq2(c0, c1)
    y = (x * x * x + B_G2).sqrt()
    if y is None:
        raise ValueError("x not on twist curve")
    y_neg = -y
    # lexicographic order on (c1, c0), matching arkworks' QuadExtField cmp
    def key(v: Fq2):
        return (v.c1, v.c0)

    largest = y if key(y) > key(y_neg) else y_neg
    smallest = y_neg if largest == y else y
    y = largest if (flags & Y_LARGEST_FLAG) else smallest
    pt = G2(x, y)
    assert pt.on_curve()
    return pt


def decode_fr(data: bytes) -> int:
    assert len(data) == 32
    return int.from_bytes(data, "little")


# ---------------------------------------------------------------------------
# Encoders (the reverse direction: what `serialize_compressed` emits in the
# reference's generate-verifier / generate-verifier-arguments CLI,
# packages/rust-verifier/src/main.rs:47-104)
# ---------------------------------------------------------------------------

def encode_g1(p: G1) -> bytes:
    if p.inf:
        raw = bytearray(32)
        raw[31] |= INF_FLAG
        return bytes(raw)
    raw = bytearray(p.x.to_bytes(32, "little"))
    if p.y > Q - p.y:
        raw[31] |= Y_LARGEST_FLAG
    return bytes(raw)


def encode_g2(p: G2) -> bytes:
    if p.inf:
        raw = bytearray(64)
        raw[63] |= INF_FLAG
        return bytes(raw)
    raw = bytearray(p.x.c0.to_bytes(32, "little") + p.x.c1.to_bytes(32, "little"))
    y_neg = -p.y
    if (p.y.c1, p.y.c0) > (y_neg.c1, y_neg.c0):
        raw[63] |= Y_LARGEST_FLAG
    return bytes(raw)


def encode_fr(x: int) -> bytes:
    return (x % (1 << 256)).to_bytes(32, "little")


def encode_proof(proof) -> bytes:
    """ark Proof<Bn254> compressed: a(G1) | b(G2) | c(G1) = 128 bytes."""
    return encode_g1(proof.a) + encode_g2(proof.b) + encode_g1(proof.c)


def encode_publics(publics: list[int]) -> bytes:
    """[Fr; N] compressed (fixed-size array: elements only, no length)."""
    return b"".join(encode_fr(x) for x in publics)


def encode_vkey(vk) -> bytes:
    """ark VerifyingKey<Bn254> compressed (see decode_vkey for layout)."""
    out = encode_g1(vk.alpha_g1) + encode_g2(vk.beta_g2)
    out += encode_g2(vk.gamma_g2) + encode_g2(vk.delta_g2)
    out += len(vk.ic).to_bytes(8, "little")
    out += b"".join(encode_g1(p) for p in vk.ic)
    return out


def decode_vkey(data: bytes):
    """arkworks VerifyingKey<Bn254> compressed layout:
    alpha_g1 | beta_g2 | gamma_g2 | delta_g2 | u64 n | n * gamma_abc_g1."""
    off = 0
    alpha = decode_g1(data[off : off + 32]); off += 32
    beta = decode_g2(data[off : off + 64]); off += 64
    gamma = decode_g2(data[off : off + 64]); off += 64
    delta = decode_g2(data[off : off + 64]); off += 64
    n = int.from_bytes(data[off : off + 8], "little"); off += 8
    ic = []
    for _ in range(n):
        ic.append(decode_g1(data[off : off + 32])); off += 32
    assert off == len(data), (off, len(data))
    return {"alpha_g1": alpha, "beta_g2": beta, "gamma_g2": gamma,
            "delta_g2": delta, "ic": ic}
