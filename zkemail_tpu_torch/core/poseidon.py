"""Poseidon hash over BN254 Fr, parameter-compatible with circomlib.

The upstream circuits hash with circomlib's Poseidon (t = 2..17); its
parameters come from the canonical Grain-LFSR generation procedure of the
Poseidon reference implementation (x^5 S-box, R_F = 8, R_P per width).  We
regenerate those parameters from the same public algorithm instead of
shipping the JSON blob, and validate against well-known circomlib test
vectors in tests/test_poseidon.py.

Reference parity targets:
  zk-email-verify packages/circuits/utils/hash.circom:15-80  (PoseidonLarge/Modular)
  zk-email-verify packages/helpers/src/hash.ts:4-54          (host-side mirror)
"""

from __future__ import annotations

import functools

from .field import R as FR_P

# circomlib round numbers: R_F is always 8; R_P indexed by t-2 (t = width = nInputs+1)
N_ROUNDS_F = 8
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
MAX_INPUTS = 16  # t up to 17


def _grain_gen(t: int, r_f: int, r_p: int, n_bits: int = 254):
    """Self-shrinking Grain LFSR bit generator per the Poseidon reference sage
    script (field=1 prime, sbox=0 i.e. x^alpha)."""
    def int_bits(v: int, width: int):
        return [(v >> (width - 1 - i)) & 1 for i in range(width)]

    state = (
        int_bits(1, 2)        # field tag: prime
        + int_bits(0, 4)      # sbox tag: x^alpha
        + int_bits(n_bits, 12)
        + int_bits(t, 12)
        + int_bits(r_f, 10)
        + int_bits(r_p, 10)
        + [1] * 30
    )
    assert len(state) == 80

    def update():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()

    while True:
        b1 = update()
        b2 = update()
        if b1 == 1:
            yield b2


def _sample_field(gen, p: int, n_bits: int = 254) -> int:
    while True:
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | next(gen)
        if v < p:
            return v


@functools.lru_cache(maxsize=None)
def poseidon_params(t: int, p: int = FR_P):
    """(round_constants, mds) for width t.

    round_constants: flat tuple of (R_F + R_P) * t field elements (row major
    by round).  mds: t x t tuple-of-tuples, M[i][j] = (x_i + y_j)^-1.
    """
    r_p = N_ROUNDS_P[t - 2]
    gen = _grain_gen(t, N_ROUNDS_F, r_p)
    n_consts = (N_ROUNDS_F + r_p) * t
    consts = tuple(_sample_field(gen, p) for _ in range(n_consts))
    # MDS: Cauchy matrix over xs, ys sampled from the continuing LFSR stream.
    # Parity (circomlib-exact, verified against the well-known circomlibjs
    # vectors poseidon([1]) / poseidon([1,2])): the round constants use
    # rejection sampling (< p), but the MDS xs/ys are RAW 254-bit draws
    # reduced mod p — no rejection.  This asymmetry is circomlib's actual
    # generation behavior; with it, this module's HADES schedule
    # (ARC -> SBOX -> MIX, new_state[i] = sum_j M[i][j] * s[j]) reproduces
    # circomlibjs outputs bit-for-bit for all widths.
    def _raw_field() -> int:
        v = 0
        for _ in range(254):
            v = (v << 1) | next(gen)
        return v % p

    xs = [_raw_field() for _ in range(t)]
    ys = [_raw_field() for _ in range(t)]
    mds = tuple(
        tuple(pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)) for i in range(t)
    )
    return consts, mds


def permute(state: list[int], p: int = FR_P) -> list[int]:
    """The Poseidon permutation on a width-t state (Python ints)."""
    t = len(state)
    consts, mds = poseidon_params(t, p)
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    n_rounds = r_f + r_p
    s = list(state)
    for r in range(n_rounds):
        s = [(s[i] + consts[r * t + i]) % p for i in range(t)]
        if r < r_f // 2 or r >= r_f // 2 + r_p:
            s = [pow(x, 5, p) for x in s]
        else:
            s[0] = pow(s[0], 5, p)
        s = [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]
    return s


def poseidon(inputs: list[int], p: int = FR_P) -> int:
    """circomlib-compatible Poseidon hash: state = [0, *inputs], output state[0]."""
    if not 1 <= len(inputs) <= MAX_INPUTS:
        raise ValueError("poseidon supports 1..16 inputs")
    state = [0] + [x % p for x in inputs]
    return permute(state, p)[0]


def poseidon_ex(inputs: list[int], initial_state: int = 0, n_outs: int = 1,
                p: int = FR_P) -> list[int]:
    """circomlib PoseidonEx: arbitrary initial state[0], multiple outputs."""
    state = [initial_state % p] + [x % p for x in inputs]
    return permute(state, p)[:n_outs]


# ---------------------------------------------------------------------------
# Host-side mirrors of the reference's hashing conventions
# (packages/helpers/src/hash.ts / packages/circuits/utils/hash.circom)
# ---------------------------------------------------------------------------

def poseidon_large(value: int, bits_per_chunk: int, num_chunks: int) -> int:
    """Hash a big integer by merging pairs of chunks, circuits/utils/hash.circom:15.

    Splits `value` into num_chunks chunks of bits_per_chunk bits, merges chunk
    pairs into num_chunks/2 (ceil) double-width chunks, Poseidon over those.
    Mirrors helpers/src/hash.ts:4 (poseidonLarge) semantics: used for the
    RSA pubkey hash as poseidonLarge(modulus, 242, 9) over 121*17-bit limbs.
    """
    mask = (1 << bits_per_chunk) - 1
    chunks = [(value >> (i * bits_per_chunk)) & mask for i in range(2 * num_chunks)]
    merged = [
        chunks[2 * i] + (chunks[2 * i + 1] << bits_per_chunk)
        for i in range(num_chunks)
    ]
    return poseidon(merged)


def poseidon_modular(values: list[int]) -> int:
    """circuits/utils/hash.circom:49 PoseidonModular: fold 16-ary chunks pairwise.

    Hash an arbitrary-length list: chunk into groups of 16, hash each, then
    fold results pairwise: out = poseidon([acc, chunk_hash]).
    """
    chunks = [values[i : i + 16] for i in range(0, len(values), 16)]
    out = None
    for c in chunks:
        h = poseidon(c)
        out = h if out is None else poseidon([out, h])
    if out is None:
        raise ValueError("empty input")
    return out
