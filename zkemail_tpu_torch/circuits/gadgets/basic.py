"""Basic constraint gadgets: bit decomposition, comparators, muxes.

Semantic parity targets: circomlib bitify/comparators/mux1 as used throughout
zk-email-verify packages/circuits (e.g. email-verifier.circom:58, sha.circom).
Each gadget emits R1CS rows and registers vectorized witness steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import field as F
from ...core import limbs as LB
from ..builder import LC, ConstraintSystem, PreparedLC, SignalVec, lift_small

L = F.LIMBS


def num2bits(cs: ConstraintSystem, x, n_bits: int) -> SignalVec:
    """Decompose x into n_bits little-endian bits (constrained booleans).

    Witness extracts bits from the limb representation, so it works for any
    field value < 2^n_bits (circomlib Num2Bits semantics).
    """
    x = LC.of(x)
    shape = x.shape
    bits = cs.alloc((n_bits,) + shape, "bits")
    cs.enforce_bit(bits)
    # sum 2^i b_i == x
    acc = LC([], 0)
    for i in range(n_bits):
        acc = acc + bits[i] * (1 << i)
    cs.enforce_equal(acc, x)

    prep = PreparedLC(x, shape)
    limb = np.arange(n_bits) // F.LIMB_BITS
    off = (np.arange(n_bits) % F.LIMB_BITS).reshape(n_bits, 1, 1).astype(np.int32)

    def step(env, prep=prep, limb=limb, off=off):
        vals = prep.eval(env)  # (L, n, B)
        bits = (vals[env.tensor(limb)] >> env.tensor(off)) & 1  # (n_bits, n, B)
        return lift_small(bits.reshape(-1, vals.shape[-1]))

    cs.set_witness(bits, step, "num2bits")
    return bits


def bits2num(cs: ConstraintSystem, bits: SignalVec) -> SignalVec:
    """Recombine little-endian bits into a number (circomlib Bits2Num)."""
    n_bits = bits.shape[0]
    acc = LC([], 0)
    for i in range(n_bits):
        acc = acc + bits[i] * (1 << i)
    return cs.define(acc, "bits2num")


def is_zero(cs: ConstraintSystem, x) -> SignalVec:
    """out = (x == 0), via the inverse hint (circomlib IsZero)."""
    x = LC.of(x)
    shape = x.shape
    inv = cs.alloc(shape, "isz_inv")
    out = cs.alloc(shape, "isz_out")
    # x * inv = 1 - out ;  x * out = 0
    cs.enforce(x, inv, 1 - LC.of(out))
    cs.enforce(x, out, LC([], 0))

    prep = PreparedLC(x, shape)

    def step_inv(env, prep=prep):
        # one Montgomery batch inversion over the step's n * B values
        xm = prep.eval(env, mont=True)
        flat = LB.batch_inv(LB.FR_SPEC, xm.reshape(L, -1))  # 0 -> 0
        return LB.from_mont(LB.FR_SPEC, flat).reshape(xm.shape)

    def step_out(env, prep=prep):
        return lift_small(LB.is_zero(prep.eval(env)).to(torch.int32))

    cs.set_witness(inv, step_inv, "is_zero.inv")
    cs.set_witness(out, step_out, "is_zero.out")
    return out


def is_equal(cs: ConstraintSystem, a, b) -> SignalVec:
    return is_zero(cs, LC.of(a) - LC.of(b))


def less_than(cs: ConstraintSystem, a, b, n_bits: int) -> SignalVec:
    """a < b for values < 2^n_bits (circomlib LessThan)."""
    diff = LC.of(a) + (1 << n_bits) - LC.of(b)
    bits = num2bits(cs, diff, n_bits + 1)
    out = cs.define(1 - bits[n_bits].lc(), "lt")
    return out


def greater_than(cs: ConstraintSystem, a, b, n_bits: int) -> SignalVec:
    return less_than(cs, b, a, n_bits)


def less_eq_than(cs: ConstraintSystem, a, b, n_bits: int) -> SignalVec:
    return less_than(cs, a, LC.of(b) + 1, n_bits)


def greater_eq_than(cs: ConstraintSystem, a, b, n_bits: int) -> SignalVec:
    return less_than(cs, LC.of(b), LC.of(a) + 1, n_bits)


def mux1(cs: ConstraintSystem, sel, a, b) -> SignalVec:
    """sel ? a : b  (sel boolean)."""
    t = cs.mul(LC.of(sel), LC.of(a) - LC.of(b), "mux_t")
    return cs.define(t + LC.of(b), "mux1")


def assert_equal_when(cs: ConstraintSystem, cond, a, b):
    """cond * (a - b) == 0."""
    cs.enforce(LC.of(cond), LC.of(a) - LC.of(b), LC([], 0))
