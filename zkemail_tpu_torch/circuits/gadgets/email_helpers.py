"""Application helper gadgets: soft-line-break removal, nullifier, substring
reveal.

Parity targets (zk-email-verify packages/circuits/helpers/):
  remove-soft-line-breaks.circom:14
  email-nullifier.circom:15
  reveal-substring.circom:13

A copy of the JAX package's module: the build side is numpy, unchanged,
and the witness steps are those of the gadgets it calls.
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .arrays import (
    count_substring_occurrences,
    select_sub_array,
)
from .basic import is_equal, less_than
from .bytes import pack_bytes
from .poseidon_gadget import poseidon_hash, poseidon_large, poseidon_modular


def remove_soft_line_breaks(
    cs: ConstraintSystem, encoded: SignalVec, decoded: SignalVec
) -> SignalVec:
    """Verify `decoded` equals `encoded` with quoted-printable '=\\r\\n'
    sequences removed (RemoveSoftLineBreaks:14).

    Soundness via a random linear combination with a Fiat-Shamir challenge
    r = PoseidonModular(pack(encoded) || pack(decoded)):
        sum_i kept_i * encoded_i * rpow_i == sum_j decoded_j * r^j
    where rpow advances only on kept positions.
    Returns an `isValid`-style implicit success (constraints fail otherwise).
    """
    n = encoded.shape[0]
    assert decoded.shape[0] == n

    # challenge r
    packed = pack_bytes(cs, SignalVec(np.concatenate([encoded.idx, decoded.idx])))
    r = poseidon_modular(cs, packed)

    # soft-break detection: position i starts '=\r\n'
    eq_e = is_equal(cs, encoded, LC([], 61))  # '='
    eq_r = is_equal(cs, encoded, LC([], 13))  # '\r'
    eq_n = is_equal(cs, encoded, LC([], 10))  # '\n'
    starts = []
    for i in range(n - 2):
        t = cs.mul(eq_e[i], eq_r[i + 1], "slb_t")
        starts.append(cs.mul(t, eq_n[i + 2], "slb_start"))
    # removed_i = start_i or start_{i-1} or start_{i-2}; patterns cannot
    # overlap ('=' != '\r'), so plain sum is boolean
    removed = []
    for i in range(n):
        acc = LC([], 0)
        for d in (0, 1, 2):
            j = i - d
            if 0 <= j < n - 2:
                acc = acc + starts[j]
        removed.append(acc)

    # running powers of r over kept positions: pow_0 = 1;
    # pow_{i+1} = pow_i * (kept_i ? r : 1) = pow_i + pow_i*(r-1)*kept_i
    pow_sig = [None] * (n + 1)
    lhs = LC([], 0)
    cur = LC([], 1)
    for i in range(n):
        kept = 1 - removed[i]
        contrib = cs.mul(cur, kept, "slb_keptpow")  # pow_i * kept_i
        term = cs.mul(contrib.lc(), encoded[i], "slb_term")
        lhs = lhs + term
        # next power: cur + contrib*(r-1)  => needs contrib * r product
        cr = cs.mul(contrib.lc(), r, "slb_cr")
        nxt = cs.define(cur - contrib.lc() + cr, "slb_pow")
        cur = LC.of(nxt)

    # rhs: sum decoded_j * r^j with plain powers
    rhs = LC([], 0)
    rp = LC([], 1)
    for j in range(n):
        term = cs.mul(rp, decoded[j], "slb_dterm")
        rhs = rhs + term
        if j < n - 1:
            rp_next = cs.mul(rp, r, "slb_rp")
            rp = LC.of(rp_next)
    cs.enforce_equal(lhs, rhs)
    return r


def email_nullifier(cs: ConstraintSystem, signature_limbs: SignalVec) -> SignalVec:
    """Poseidon(PoseidonLarge(signature)) (EmailNullifier:15)."""
    inner = poseidon_large(cs, signature_limbs)
    return poseidon_hash(cs, SignalVec(inner.idx.reshape(1)))


def reveal_substring(
    cs: ConstraintSystem,
    text: SignalVec,
    substring_start,
    substring_length,
    max_substring_len: int,
    enforce_uniqueness: bool = False,
) -> SignalVec:
    """Bounds-checked substring selection (RevealSubstring:13)."""
    n = text.shape[0]
    n_bits = 12 if n < 4096 else 16
    lt1 = less_than(cs, LC.of(substring_start), LC([], n), n_bits)
    cs.enforce_equal(lt1.lc(), LC([], 1))
    lt2 = less_than(
        cs, LC.of(substring_start) + LC.of(substring_length), LC([], n + 1), n_bits + 1
    )
    cs.enforce_equal(lt2.lc(), LC([], 1))
    lt3 = less_than(cs, LC.of(substring_length), LC([], max_substring_len + 1), n_bits)
    cs.enforce_equal(lt3.lc(), LC([], 1))
    sub = select_sub_array(cs, text, substring_start, substring_length, max_substring_len)
    if enforce_uniqueness:
        cnt = count_substring_occurrences(cs, text, sub)
        cs.enforce_equal(cnt.lc(), LC([], 1))
    return sub
