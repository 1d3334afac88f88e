"""Keccak-256 (the pre-NIST padding variant used by Ethereum/Solidity).

Needed for DKIMRegistry domain hashing parity (keccak256(domainName) in
zkemail_tpu/contracts/DKIMRegistry.sol) — hashlib only ships SHA3 (different
padding).  Implemented from the Keccak specification.

A copy of ``zkemail_tpu/utils/keccak.py``,
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _keccak_f(state: list[int]) -> list[int]:
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTATIONS[x][y])
        # chi
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64) for y in range(5)]
            for x in range(5)
        ]
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak_256(data: bytes) -> bytes:
    rate = 136  # bytes (1088-bit rate for 256-bit output)
    state = [0] * 25
    # pad: 0x01 ... 0x80 (Keccak padding, NOT SHA3's 0x06)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = _keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
