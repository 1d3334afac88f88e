"""Array-manipulation gadgets.

Semantic parity with zk-email-verify packages/circuits/utils/array.circom:
ItemAtIndex:16, CalculateTotal:51, SelectSubArray:77, VarShiftLeft:111,
AssertZeroPadding:149, Slice:175, CheckSubstringMatch:194,
CountSubstringOccurrences:226.
"""

from __future__ import annotations

import numpy as np

from ..builder import LC, ConstraintSystem, SignalVec
from .basic import is_equal, is_zero, less_than, num2bits


def log2_ceil(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def calculate_total(cs: ConstraintSystem, arr: SignalVec) -> SignalVec:
    """Sum of all elements (CalculateTotal:51)."""
    acc = LC([], 0)
    for i in range(arr.shape[0]):
        acc = acc + arr[i]
    return cs.define(acc, "total")


def item_at_index(cs: ConstraintSystem, arr: SignalVec, index) -> SignalVec:
    """Guarded Quin selector: arr[index] with index-validity sum == 1
    (ItemAtIndex:16). arr shape (N,)."""
    n = arr.shape[0]
    iota = np.arange(n, dtype=object)
    eq = is_zero(cs, LC.of(index) - SignalVec(np.broadcast_to(np.zeros((), np.int64), (n,))) * 0 - iota if False else _index_minus_iota(index, n))
    # sum of equality indicators must be exactly 1 (index in range)
    total = LC([], 0)
    for i in range(n):
        total = total + eq[i]
    cs.enforce_equal(total, LC([], 1))
    prods = cs.mul(eq, arr, "quin_prod")
    out = LC([], 0)
    for i in range(n):
        out = out + prods[i]
    return cs.define(out, "item_at_index")


def _index_minus_iota(index, n: int) -> LC:
    lc = LC.of(index)
    iota = np.arange(n, dtype=object)
    # broadcast: (index - i) for each i
    return lc - LC([], iota)


def var_shift_left(
    cs: ConstraintSystem, arr: SignalVec, shift, max_out_len: int
) -> SignalVec:
    """out[i] = arr[i + shift], zeros beyond the array (VarShiftLeft:111).

    Log-depth barrel shifter over the bits of `shift`.
    """
    n = arr.shape[0]
    n_bits = log2_ceil(n)
    shift_bits = num2bits(cs, shift, n_bits)
    layer = arr
    cur_len = n
    for b in range(n_bits):
        step = 1 << b
        nxt_idx = []
        shifted_terms = []
        # layer_next[i] = bit ? layer[i+step] : layer[i]
        hi = np.empty(cur_len, dtype=np.int64)
        for i in range(cur_len):
            hi[i] = layer.idx.reshape(-1)[i + step] if i + step < cur_len else 0
        hi_sv = SignalVec(hi)  # index 0 = the ONE signal? no: 0 is ONE; careful!
        # positions falling off the end read zero — use coefficient masking:
        mask = np.array([1 if i + step < cur_len else 0 for i in range(cur_len)], dtype=object)
        sel = shift_bits[b]
        # next = layer + bit * (hi*mask - layer)
        diff = LC([(hi_sv, mask), (layer, np.full(cur_len, -1, dtype=object))])
        t = cs.mul(sel.lc(), diff, "shift_t")
        layer = cs.define(t.lc() + layer.lc(), "shift_layer")
        cur_len = cur_len
    return layer[:max_out_len]


def select_sub_array(
    cs: ConstraintSystem, arr: SignalVec, start, length, max_sub_len: int
) -> SignalVec:
    """Shift left by start, zero elements >= length (SelectSubArray:77)."""
    shifted = var_shift_left(cs, arr, start, max_sub_len)
    n_bits = log2_ceil(max_sub_len) + 1
    iota = np.arange(max_sub_len, dtype=object)
    lt = less_than(cs, LC([], iota), LC.of(length), n_bits)  # i < length
    return cs.mul(lt, shifted, "subarray")


def assert_zero_padding(cs: ConstraintSystem, arr: SignalVec, length):
    """arr[i] == 0 for all i >= length (AssertZeroPadding:149)."""
    n = arr.shape[0]
    n_bits = log2_ceil(n) + 1
    iota = np.arange(n, dtype=object)
    lt = less_than(cs, LC([], iota), LC.of(length), n_bits)  # i < length
    # (1 - lt) * arr == 0
    cs.enforce(1 - lt.lc(), arr, LC([], 0))


def slice_fixed(cs: ConstraintSystem, arr: SignalVec, start: int, end: int) -> SignalVec:
    """Compile-time slice (Slice:175)."""
    return arr[start:end]


def check_substring_match(
    cs: ConstraintSystem, arr: SignalVec, substring: SignalVec, start_index
):
    """assert arr[start+j] == substring[j] for all j (CheckSubstringMatch:194)."""
    sub_len = substring.shape[0]
    shifted = var_shift_left(cs, arr, start_index, sub_len)
    cs.enforce_equal(shifted.lc(), substring.lc())


def count_substring_occurrences(
    cs: ConstraintSystem, arr: SignalVec, substring: SignalVec
) -> SignalVec:
    """Number of positions where substring matches (CountSubstringOccurrences:226)."""
    n = arr.shape[0]
    m = substring.shape[0]
    matches = []
    for i in range(n - m + 1):
        window = arr[i : i + m]
        eqs = is_equal(cs, window, substring)  # (m,)
        prod = eqs[0]
        for j in range(1, m):
            prod = cs.mul(prod, eqs[j], "substr_and")
        matches.append(prod)
    total = LC([], 0)
    for sv in matches:
        total = total + sv
    return cs.define(total, "substr_count")
