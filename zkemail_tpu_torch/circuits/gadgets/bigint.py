"""Non-native bigint arithmetic over 121-bit x 17 limbs.

Parity targets: zk-email-verify packages/circuits/lib/{fp,bigint,bigint-func}.circom —
FpMul:16 (a*b mod p via 2k-1 polynomial evaluations + long-division hints),
BigLessThan:16, CheckCarryToZero:69; the witness-time hint functions
(long_div etc., bigint-func.circom:32-264) live host-side in
`circuits/advice.py` exactly as circom's `<--` assignments do.
"""

from __future__ import annotations

import numpy as np

from ...core.field import R as P
from ..builder import LC, ConstraintSystem, SignalVec
from .basic import is_equal, less_than, num2bits

N_BITS = 121
K_LIMBS = 17


def limbs_lc(limbs: SignalVec, base_bits: int = N_BITS) -> LC:
    """Recombine limb signals into one value-LC (fits in Fr for <= 2 limbs)."""
    acc = LC([], 0)
    for i in range(limbs.shape[0]):
        acc = acc + limbs[i] * (1 << (base_bits * i))
    return acc


def range_check_limbs(cs: ConstraintSystem, limbs: SignalVec, bits: int = N_BITS):
    num2bits(cs, limbs, bits)


def big_less_than(cs: ConstraintSystem, a: SignalVec, b: SignalVec) -> SignalVec:
    """a < b over k-limb bigints (BigLessThan:16). Limbs must be range-checked."""
    k = a.shape[0]
    lt = less_than(cs, a, b, N_BITS)  # (k,) limbwise a_i < b_i
    eq = is_equal(cs, a, b)  # (k,)
    # scan from most-significant: out = lt[k-1] + eq[k-1]*(lt[k-2] + eq[k-2]*(...))
    out = lt[k - 1].lc()
    cum = eq[k - 1]
    for i in range(k - 2, -1, -1):
        t = cs.mul(cum, lt[i], "blt_t")
        out = out + t
        if i > 0:
            cum = cs.mul(cum, eq[i], "blt_cum")
    return cs.define(out, "big_lt")


def _interp_matrix(n_points: int) -> np.ndarray:
    """Inverse Vandermonde over points 0..n_points-1 (mod P), object dtype.

    coeffs = M @ evals  recovers polynomial coefficients from evaluations.
    """
    # Lagrange: coeff_j = sum_x evals[x] * l_x[j] where l_x is the basis poly
    M = np.zeros((n_points, n_points), dtype=object)
    for x in range(n_points):
        # l_x(t) = prod_{y!=x} (t - y) / (x - y)
        num = [1]  # polynomial coefficients, little-endian
        denom = 1
        for y in range(n_points):
            if y == x:
                continue
            # multiply num by (t - y)
            new = [0] * (len(num) + 1)
            for i, c in enumerate(num):
                new[i] = (new[i] - y * c) % P
                new[i + 1] = (new[i + 1] + c) % P
            num = new
            denom = denom * (x - y) % P
        dinv = pow(denom % P, -1, P)
        for j in range(n_points):
            M[j, x] = num[j] * dinv % P
    return M


def check_carry_to_zero(
    cs: ConstraintSystem,
    d_lcs: list,  # list of per-coefficient LCs (length m)
    carries: SignalVec,  # (m-1,) hint signals (field repr of signed carries)
    limb_bits: int = N_BITS,
    carry_bits: int = 130,  # 2^(130+121) < P: no field wraparound, so the chain is sound
):
    """Assert sum_i d_i * 2^(limb_bits*i) == 0 via a carry chain
    (CheckCarryToZero:69). carries[i] is the signed carry out of position i,
    range-checked in [-2^carry_bits, 2^carry_bits) via an offset decomposition.
    """
    m = len(d_lcs)
    base = 1 << limb_bits
    # range-check carries: carries[i] + 2^carry_bits in [0, 2^(carry_bits+1))
    num2bits(cs, carries.lc() + (1 << carry_bits), carry_bits + 1)
    for i in range(m):
        if i == 0:
            lhs = d_lcs[0]
        else:
            lhs = d_lcs[i] + carries[i - 1]
        if i < m - 1:
            cs.enforce_equal(lhs, carries[i] * base)
        else:
            cs.enforce_zero(lhs)


def fp_mul(
    cs: ConstraintSystem,
    a: SignalVec,  # (k,) limbs
    b: SignalVec,  # (k,) limbs
    modulus: SignalVec,  # (k,) limbs (signal, e.g. the RSA pubkey)
    q: SignalVec,  # (k,) hint limbs: quotient of a*b / modulus
    r: SignalVec,  # (k,) hint limbs: remainder  (the result)
    carries: SignalVec,  # (2k-2,) hint carry signals
    range_check_hints: bool = True,
    check_r_lt_modulus: bool = True,
) -> SignalVec:
    """r = a * b mod modulus (FpMul:16).

    Verifies a*b - q*modulus - r == 0 as integers via 2k-1 point evaluations,
    Lagrange interpolation back to coefficients, and a carry chain; asserts
    the remainder is fully reduced (r < modulus, fp.circom:36-56 BigLessThan)
    so intermediate results are the canonical representatives the audited
    reference circuit guarantees. Returns r.
    """
    k = a.shape[0]
    n_pts = 2 * k - 1
    if range_check_hints:
        range_check_limbs(cs, q)
        range_check_limbs(cs, r)
    if check_r_lt_modulus:
        lt = big_less_than(cs, r, modulus)
        cs.enforce_equal(lt.lc(), LC([], 1))

    # point evaluations: A(x)*B(x) = vab[x]; Q(x)*M(x) = vqm[x]
    xs = np.arange(n_pts, dtype=object)
    powers = np.zeros((n_pts, k), dtype=object)  # powers[x, j] = x^j mod P
    for x in range(n_pts):
        acc = 1
        for j in range(k):
            powers[x, j] = acc
            acc = acc * x % P

    def eval_all(limbs: SignalVec) -> LC:
        """(n_pts,)-shaped LC: evaluation of the limb polynomial at every point."""
        return LC([(limbs[j], powers[:, j]) for j in range(k)])

    vab_all = cs.mul(eval_all(a), eval_all(b), "fpmul_vab")  # (n_pts,)
    vqm_all = cs.mul(eval_all(q), eval_all(modulus), "fpmul_vqm")
    vab = [vab_all[x] for x in range(n_pts)]
    vqm = [vqm_all[x] for x in range(n_pts)]

    M = _interp_matrix(n_pts)
    d_lcs = []
    for i in range(n_pts):
        acc = LC([], 0)
        for x in range(n_pts):
            c = int(M[i, x])
            if c:
                acc = acc + vab[x] * c + vqm[x] * (P - c)
        if i < k:
            acc = acc - r[i]
        d_lcs.append(acc)
    check_carry_to_zero(cs, d_lcs, carries)
    return r
