"""Byte-level SHA-256 circuit wrappers with variable length + midstate.

Parity targets (packages/circuits/lib/sha.circom):
  Sha256Bytes:17      — byte array + padded length -> 256 digest bits
  Sha256BytesPartial:47 — same, resuming from a 32-byte midstate
  (the variable-length output mux of Sha256General:89/190-198)
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import field as F
from ..builder import LC, ConstraintSystem, SignalVec
from .basic import is_zero, num2bits
from .sha256 import Sha256Instance, _word_lc

P = F.R
INV64 = pow(64, -1, P)


def _byte_word_matrix(byte_sv: SignalVec, nb: int) -> list:
    """Map (nb*64,) byte signals to per-word BE byte SignalVecs."""
    idx = byte_sv.idx.reshape(nb, 16, 4)
    return [SignalVec(idx[:, :, k]) for k in range(4)]  # each (nb, 16)


def sha256_bytes(
    cs: ConstraintSystem,
    data_bytes: SignalVec,  # (max_len,) byte signals (already SHA-padded)
    padded_len,  # signal: FIPS-padded byte length (multiple of 64)
    midstate_words: SignalVec | None = None,
    get_midstate=None,
):
    """Returns (digest_bits, sha) where digest_bits is (8, 32) LSB-first word
    bits of the variable-length digest (selected at padded_len/64 blocks)."""
    max_len = data_bytes.shape[0]
    assert max_len % 64 == 0, "maxByteLength must be a multiple of 64"
    nb = max_len // 64

    # per-byte 8-bit range checks (Sha256Bytes repack, sha.circom:17-38).
    # Load-bearing for soundness: the word-tie below is LINEAR, so without
    # these a prover could shift +-256 between adjacent bytes (same words,
    # same digest) and feed forged byte values to downstream byte-level
    # gadgets (regex DFA, zero-padding, masking).
    num2bits(cs, data_bytes, 8)

    def get_block_words(env, data_bytes=data_bytes, nb=nb):
        bvals = env.u32(data_bytes)  # (max_len, B) int64
        w = bvals.reshape(nb, 16, 4, bvals.shape[-1])
        return (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | (w[:, :, 2] << 8) | w[:, :, 3]

    sha = Sha256Instance(cs, nb, get_block_words, midstate_words, get_midstate)

    # tie message words to the byte signals: word == BE-combined bytes
    b0, b1, b2, b3 = _byte_word_matrix(data_bytes, nb)
    word_lc = LC([(b0, 1 << 24), (b1, 1 << 16), (b2, 1 << 8), (b3, 1)])
    msg_word_lc = _word_lc(SignalVec(sha.msg_bits.idx))  # (nb, 16)
    cs.enforce_equal(word_lc, msg_word_lc)

    # variable-length output mux: digest = state after padded_len/64 blocks
    n_blocks_lc = LC.of(padded_len) * INV64  # exact: len % 64 == 0
    iota = np.arange(1, nb + 1, dtype=object)
    sel = is_zero(cs, n_blocks_lc - LC([], iota))  # (nb,)
    total = LC([], 0)
    for k in range(nb):
        total = total + sel[k]
    cs.enforce_equal(total, LC([], 1))

    states = sha.all_states()  # (nb, 8, 32) bit signals
    sel_b = SignalVec(np.broadcast_to(sel.idx[:, None, None], (nb, 8, 32)))
    prods = cs.mul(sel_b, states, "sha_outmux")
    out = LC([], 0)
    for k in range(nb):
        out = out + prods[k]
    digest_bits = cs.define(out, "sha_digest")  # (8, 32)
    return digest_bits, sha


def sha256_bytes_partial(
    cs: ConstraintSystem,
    data_bytes: SignalVec,
    padded_len,
    midstate_bytes: SignalVec,  # (32,) byte signals of the cached state
):
    """Sha256BytesPartial: seed the compression chain from a 32-byte midstate."""
    # midstate words (8,) as LCs over the bytes (BE within each word)
    idx = midstate_bytes.idx.reshape(8, 4)
    words = []
    for wi in range(8):
        words.append(
            LC(
                [
                    (SignalVec(idx[wi, 0]), 1 << 24),
                    (SignalVec(idx[wi, 1]), 1 << 16),
                    (SignalVec(idx[wi, 2]), 1 << 8),
                    (SignalVec(idx[wi, 3]), 1),
                ]
            )
        )
    # range-check the midstate bytes, then allocate 8 word signals tied to
    # the byte LCs (same linear-tie soundness argument as sha256_bytes)
    num2bits(cs, midstate_bytes, 8)
    ws = cs.alloc((8,), "sha_midstate_words")
    for wi in range(8):
        cs.enforce_equal(words[wi], ws[wi])

    def get_midstate(env, midstate_bytes=midstate_bytes):
        w = env.u32(midstate_bytes).reshape(8, 4, -1)  # (8, 4, B) int64
        return (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]

    def ws_witness(env):
        vals = get_midstate(env)  # full 32-bit words
        out = torch.zeros((F.LIMBS,) + tuple(vals.shape), dtype=torch.int32,
                          device=vals.device)
        out[0] = vals & 0xFFF
        out[1] = (vals >> 12) & 0xFFF
        out[2] = (vals >> 24) & 0xFF
        return out

    cs.set_witness(ws, ws_witness, "sha_midstate_words")

    return sha256_bytes(cs, data_bytes, padded_len, ws, get_midstate)


def pack_digest_hi_lo(cs: ConstraintSystem, digest_bits: SignalVec):
    """(8, 32) word bits (LSB-first) -> (shaHi, shaLo) 128-bit halves.

    Mirrors PackBits big-endian packing used for the public digest outputs
    (email-verifier.circom:68-71, utils/bytes.circom:194).
    """
    # digest MSB-first bit sequence: word wi from bit 31 down to 0
    hi = LC([], 0)
    lo = LC([], 0)
    for wi in range(8):
        for j in range(32):
            pos = wi * 32 + (31 - j)  # position in MSB-first order
            weight = 1 << (127 - (pos % 128))
            if pos < 128:
                hi = hi + digest_bits[wi, j] * weight
            else:
                lo = lo + digest_bits[wi, j] * weight
    sha_hi = cs.define(hi, "shaHi")
    sha_lo = cs.define(lo, "shaLo")
    return sha_hi, sha_lo
