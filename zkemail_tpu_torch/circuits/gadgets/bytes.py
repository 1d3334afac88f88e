"""Byte-packing gadgets.

Parity targets: zk-email-verify packages/circuits/utils/bytes.circom —
PackBytes:28, PackByteSubArray:72, DigitBytesToInt:100, SplitBytesToWords:125,
AssertBit:155, ByteMask:173, PackBits:194.
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .arrays import select_sub_array
from .basic import num2bits

MAX_BYTES_IN_FIELD = 31


def pack_bytes(cs: ConstraintSystem, data: SignalVec) -> SignalVec:
    """Pack bytes into field elements, 31 bytes per element, little-endian
    (PackBytes:28)."""
    n = data.shape[0]
    n_fields = (n + MAX_BYTES_IN_FIELD - 1) // MAX_BYTES_IN_FIELD
    outs = []
    for k in range(n_fields):
        acc = LC([], 0)
        for j in range(MAX_BYTES_IN_FIELD):
            i = k * MAX_BYTES_IN_FIELD + j
            if i < n:
                acc = acc + data[i] * (1 << (8 * j))
        outs.append(cs.define(acc, "packed"))
    return SignalVec(np.stack([o.idx for o in outs]))


def pack_byte_sub_array(
    cs: ConstraintSystem, data: SignalVec, start, length, max_sub_len: int
) -> SignalVec:
    """SelectSubArray then PackBytes (PackByteSubArray:72)."""
    sub = select_sub_array(cs, data, start, length, max_sub_len)
    return pack_bytes(cs, sub)


def digit_bytes_to_int(cs: ConstraintSystem, digits: SignalVec) -> SignalVec:
    """ASCII digit bytes -> integer (DigitBytesToInt:100)."""
    n = digits.shape[0]
    acc = LC([], 0)
    for i in range(n):
        acc = acc * 1  # keep type
        acc = acc + (digits[i] - 48) * (10 ** (n - 1 - i))
    return cs.define(acc, "digits_int")


def split_bytes_to_words(
    cs: ConstraintSystem, data: SignalVec, word_bits: int, n_words: int
) -> SignalVec:
    """l bytes (big-endian integer) -> n-bit x k little-endian words
    (SplitBytesToWords:125). Used to feed RSA limbs from hash bytes."""
    n_bytes = data.shape[0]
    # bits of each byte (LSB-first per byte)
    byte_bits = num2bits(cs, data, 8)  # (8, n_bytes)
    # global bit i (LSB of the big integer) = byte (n_bytes-1 - i//8), bit i%8
    words = []
    for wi in range(n_words):
        acc = LC([], 0)
        for b in range(word_bits):
            gbit = wi * word_bits + b
            if gbit >= 8 * n_bytes:
                continue
            byte_idx = n_bytes - 1 - (gbit // 8)
            bit_idx = gbit % 8
            acc = acc + byte_bits[bit_idx, byte_idx] * (1 << b)
        words.append(cs.define(acc, "word"))
    return SignalVec(np.stack([w.idx for w in words]))


def assert_bit(cs: ConstraintSystem, sv: SignalVec):
    cs.enforce_bit(sv)


def byte_mask(cs: ConstraintSystem, data: SignalVec, mask: SignalVec) -> SignalVec:
    """out[i] = data[i] * mask[i], mask constrained boolean (ByteMask:173)."""
    cs.enforce_bit(mask)
    return cs.mul(data, mask, "byte_mask")


def pack_bits(cs: ConstraintSystem, bits: SignalVec, chunk_bits: int) -> SignalVec:
    """Pack an MSB-first bit array into chunk_bits-sized values (PackBits:194)."""
    n = bits.shape[0]
    n_chunks = (n + chunk_bits - 1) // chunk_bits
    outs = []
    for k in range(n_chunks):
        acc = LC([], 0)
        for j in range(chunk_bits):
            i = k * chunk_bits + j
            if i < n:
                acc = acc + bits[i] * (1 << (chunk_bits - 1 - j))
        outs.append(cs.define(acc, "packed_bits"))
    return SignalVec(np.stack([o.idx for o in outs]))
