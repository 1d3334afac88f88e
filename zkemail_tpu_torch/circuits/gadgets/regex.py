"""Regex-reveal interface gadgets.

Parity targets: zk-email-verify packages/circuits/utils/regex.circom —
SelectRegexReveal:17 (zero-outside-window assertion + shift),
PackRegexReveal:62.  The BodyHashRegex DFA itself lives in
circuits/regex_compiler.py + gadgets/regex_dfa.py (the zk-regex role,
email-verifier.circom:124-131).
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .arrays import var_shift_left
from .basic import is_zero, less_than
from .bytes import pack_bytes


def select_regex_reveal(
    cs: ConstraintSystem,
    reveal_array: SignalVec,  # (maxLen,) — zero outside the match
    start_index,
    max_reveal_len: int,
) -> SignalVec:
    """Shift the reveal window to position 0, asserting all-zero outside
    (SelectRegexReveal:17)."""
    n = reveal_array.shape[0]
    iota = np.arange(n, dtype=object)
    # before start: i < start -> must be zero;
    lt_start = less_than(cs, LC([], iota), LC.of(start_index), 12)
    cs.enforce(lt_start, reveal_array, LC([], 0))
    # nonzero at start (match begins there): reveal[start] != 0 via shifted[0]
    shifted = var_shift_left(cs, reveal_array, start_index, max_reveal_len)
    nz = is_zero(cs, shifted[0])
    cs.enforce_equal(nz.lc(), LC([], 0))
    # after start + maxRevealLen: zero (i >= start + len -> reveal == 0)
    ge_end = less_than(cs, LC.of(start_index) + max_reveal_len - 1, LC([], iota), 12)
    cs.enforce(ge_end, reveal_array, LC([], 0))
    return shifted


def pack_regex_reveal(
    cs: ConstraintSystem, reveal_array: SignalVec, start_index, max_reveal_len: int
) -> SignalVec:
    """SelectRegexReveal then PackBytes (PackRegexReveal:62)."""
    revealed = select_regex_reveal(cs, reveal_array, start_index, max_reveal_len)
    return pack_bytes(cs, revealed)
