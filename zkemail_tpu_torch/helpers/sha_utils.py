"""SHA-256 with midstate checkpointing + circuit padding helpers.

The midstate trick is the reference's core cost saver: hash the body prefix on
the host, hand the 32-byte compression state to the circuit, and prove only
the suffix (packages/helpers/src/lib/fast-sha256.ts:240 cacheState;
packages/helpers/src/sha-utils.ts:30-111).  This is a from-scratch Python
implementation with the same capabilities.
"""

from __future__ import annotations

import struct

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(state: tuple, block: bytes) -> tuple:
    """One SHA-256 compression round on a 64-byte block."""
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + _K[i] + w[i]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return tuple((x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def sha256_state(data: bytes, state: tuple = IV) -> tuple:
    """Run compressions over len(data) (must be a multiple of 64) from state."""
    assert len(data) % 64 == 0
    for i in range(0, len(data), 64):
        state = compress(state, data[i : i + 64])
    return state


def state_to_bytes(state: tuple) -> bytes:
    return struct.pack(">8I", *state)


def bytes_to_state(b: bytes) -> tuple:
    return struct.unpack(">8I", b)


def sha256(data: bytes) -> bytes:
    padded, _ = sha256_pad(data, ((len(data) + 9 + 63) // 64) * 64)
    return state_to_bytes(sha256_state(padded))


def sha256_pad(data: bytes, max_sha_bytes: int) -> tuple[bytes, int]:
    """FIPS 180-4 padding, then zero-extend to max_sha_bytes.

    Returns (padded, padded_len) where padded_len is the byte length including
    FIPS padding (a multiple of 64) — the circuit's in_len_padded_bytes.
    Mirrors packages/helpers/src/sha-utils.ts:88 semantics.
    """
    bit_len = len(data) * 8
    padded = data + b"\x80"
    while len(padded) % 64 != 56:
        padded += b"\x00"
    padded += struct.pack(">Q", bit_len)
    padded_len = len(padded)
    if padded_len > max_sha_bytes:
        raise ValueError(
            f"message needs {padded_len} bytes > max {max_sha_bytes}; "
            "increase the max length parameter"
        )
    padded += b"\x00" * (max_sha_bytes - padded_len)
    return padded, padded_len


def partial_sha(data: bytes) -> bytes:
    """Midstate after compressing a 64-byte-aligned prefix (cacheState())."""
    return state_to_bytes(sha256_state(data))


def generate_partial_sha(
    body: bytes,
    body_sha_length: int,
    precompute_selector: str | None = None,
    max_remaining_body_length: int = 0,
) -> tuple[bytes, bytes, int]:
    """Split the padded body at a 64-byte boundary before the selector.

    body: sha256-padded body; body_sha_length: FIPS-padded length.
    Returns (precomputed_sha_midstate_32B, body_remaining_padded,
    body_remaining_len).  Mirrors packages/helpers/src/sha-utils.ts:30-80.
    """
    if precompute_selector is None:
        cut = 0
    else:
        sel = precompute_selector.encode()
        idx = body.find(sel)
        if idx == -1:
            raise ValueError(f"selector {precompute_selector!r} not found in body")
        cut = (idx // 64) * 64
    precomputed = partial_sha(body[:cut])
    remaining = body[cut:]
    remaining_len = body_sha_length - cut
    if max_remaining_body_length:
        if len(remaining) > max_remaining_body_length:
            remaining = remaining[:max_remaining_body_length]
            if remaining_len > max_remaining_body_length:
                raise ValueError(
                    "remaining body after selector exceeds maxRemainingBodyLength"
                )
        else:
            remaining = remaining + b"\x00" * (max_remaining_body_length - len(remaining))
    return precomputed, remaining, remaining_len
