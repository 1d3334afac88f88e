"""Base64 decoding constraints.

Parity target: zk-email-verify packages/circuits/lib/base64.circom —
Base64Decode:14 (4 chars -> 3 bytes bit repacking), Base64Lookup:71
(range-arithmetic table with validity sum === 1; '=' decodes as 'A', the
documented caveat at base64.circom:9-10).
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .basic import is_equal, less_than, num2bits


def base64_lookup(cs: ConstraintSystem, chars: SignalVec) -> SignalVec:
    """Map base64 ASCII codes to 6-bit values; constrains validity.

    chars: any shape of byte signals. Returns same-shape 6-bit values.
    """
    # range indicators
    def in_range(lo, hi):
        ge = less_than(cs, LC([], lo - 1), chars, 8)  # lo-1 < c  <=>  c >= lo
        le = less_than(cs, chars, LC([], hi + 1), 8)  # c < hi+1  <=>  c <= hi
        return cs.mul(ge, le, "b64_range")

    upper = in_range(65, 90)   # 'A'-'Z' -> c - 65
    lower = in_range(97, 122)  # 'a'-'z' -> c - 71
    digit = in_range(48, 57)   # '0'-'9' -> c + 4
    plus = is_equal(cs, chars, LC([], 43))   # '+' -> 62
    slash = is_equal(cs, chars, LC([], 47))  # '/' -> 63
    eq = is_equal(cs, chars, LC([], 61))     # '=' -> 0 (treated as 'A')

    total = upper + lower.lc() + digit + plus + slash + eq
    cs.enforce_equal(total, LC([], 1))

    # out = upper*(c-65) + lower*(c-71) + digit*(c+4) + plus*62 + slash*63
    t1 = cs.mul(upper, LC.of(chars) - 65, "b64_u")
    t2 = cs.mul(lower, LC.of(chars) - 71, "b64_l")
    t3 = cs.mul(digit, LC.of(chars) + 4, "b64_d")
    out = cs.define(
        t1 + t2.lc() + t3 + plus * 62 + slash * 63, "b64_val"
    )
    return out


def base64_decode(cs: ConstraintSystem, chars: SignalVec, n_bytes: int) -> SignalVec:
    """Decode ceil(n/3)*4 base64 chars into n bytes (Base64Decode:14)."""
    n_chars = chars.shape[0]
    assert n_chars == 4 * ((n_bytes + 2) // 3), (n_chars, n_bytes)
    vals = base64_lookup(cs, chars)  # 6-bit values
    bits = num2bits(cs, vals, 6)  # (6, n_chars)
    out_bytes = []
    for i in range(n_bytes):
        group, pos = divmod(i, 3)
        # byte i bits come from chars 4*group .. 4*group+3
        # bit stream (MSB-first): char c contributes bits 5..0
        acc = LC([], 0)
        for b in range(8):
            stream_pos = pos * 8 + b  # MSB-first position within the 24-bit group
            char_idx = 4 * group + stream_pos // 6
            bit_idx = 5 - (stream_pos % 6)  # MSB-first within the char
            acc = acc + bits[bit_idx, char_idx] * (1 << (7 - b))
        out_bytes.append(cs.define(acc, "b64_byte"))
    return SignalVec(np.stack([o.idx for o in out_bytes]))
