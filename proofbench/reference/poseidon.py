"""circomlib's Poseidon over BN254's scalar field, and PoseidonLarge.

A frozen copy of ``zkemail_tpu_torch/core/poseidon.py``: the parameters are
generated by the Poseidon reference's Grain LFSR (x^5 S-box, R_F = 8, R_P by
width), with circomlib's asymmetry of rejection-sampled round constants and
raw-reduced MDS draws. Held to circomlibjs' vector poseidon([1, 2]) in
``proofbench/tests``.
"""

from __future__ import annotations

import functools

from .bn254 import R

N_ROUNDS_F = 8
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]


def _grain_bits(t: int, r_p: int):
    state = ([0, 1] + [0] * 4 + [int(b) for b in f"{254:012b}{t:012b}"]
             + [int(b) for b in f"{N_ROUNDS_F:010b}{r_p:010b}"] + [1] * 30)

    def update():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()
    while True:
        b1, b2 = update(), update()
        if b1:
            yield b2


def _draw(bits) -> int:
    v = 0
    for _ in range(254):
        v = (v << 1) | next(bits)
    return v


@functools.lru_cache(maxsize=None)
def params(t: int):
    """(round constants, MDS matrix) of width t."""
    r_p = N_ROUNDS_P[t - 2]
    bits = _grain_bits(t, r_p)
    consts = []
    while len(consts) < (N_ROUNDS_F + r_p) * t:
        v = _draw(bits)
        if v < R:
            consts.append(v)
    xs = [_draw(bits) % R for _ in range(t)]
    ys = [_draw(bits) % R for _ in range(t)]
    mds = [[pow((x + y) % R, -1, R) for y in ys] for x in xs]
    return consts, mds


def poseidon(inputs: list[int]) -> int:
    t = len(inputs) + 1
    consts, mds = params(t)
    r_p = N_ROUNDS_P[t - 2]
    s = [0] + [x % R for x in inputs]
    for r in range(N_ROUNDS_F + r_p):
        s = [(s[i] + consts[r * t + i]) % R for i in range(t)]
        if r < N_ROUNDS_F // 2 or r >= N_ROUNDS_F // 2 + r_p:
            s = [pow(x, 5, R) for x in s]
        else:
            s[0] = pow(s[0], 5, R)
        s = [sum(m * x for m, x in zip(row, s)) % R for row in mds]
    return s[0]


def poseidon_large(modulus: int) -> int:
    """zk-email's PoseidonLarge of an RSA modulus in 17 limbs of 121 bits
    (circuits/utils/hash.circom): the limbs merged in pairs, which are the
    modulus' chunks of 242 bits, then one Poseidon over the 9 chunks."""
    return poseidon([(modulus >> (242 * i)) & ((1 << 242) - 1) for i in range(9)])
