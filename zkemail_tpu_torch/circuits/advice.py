"""Host-side non-deterministic advice (the circom `<--` hint role).

Computes, with fast Python bigints, the witness hints that the constraint
system validates: RSA long-division quotients/remainders and the
CheckCarryToZero carry chains (parity with
packages/circuits/lib/bigint-func.circom:32-264 long_div / carry logic).
Outputs are Fr limb arrays shaped for the corresponding `fr` circuit inputs.
"""

from __future__ import annotations

import numpy as np

from ..core import limbs as LB
from ..core.field import R as P
from .gadgets.bigint import K_LIMBS, N_BITS


def _to_limbs(x: int, k: int = K_LIMBS, bits: int = N_BITS) -> list[int]:
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(k)]


def _conv(a: list[int], b: list[int]) -> list[int]:
    k = len(a)
    out = [0] * (2 * k - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out


def fp_mul_advice(a: int, b: int, n: int):
    """(q, r, carries) hints for one fp_mul of a*b mod n."""
    q, r = divmod(a * b, n)
    al, bl, ql, nl, rl = (_to_limbs(v) for v in (a, b, q, n, r))
    d = [x - y for x, y in zip(_conv(al, bl), _conv(ql, nl))]
    for i in range(K_LIMBS):
        d[i] -= rl[i]
    carries = []
    c = 0
    base = 1 << N_BITS
    for i in range(len(d) - 1):
        c = (d[i] + c) // base if i == 0 else (d[i] + c) // base
        # exactness check (the telescoped sum is divisible)
        carries.append(c)
    assert d[-1] + carries[-1] == 0, "carry chain must close"
    return ql, rl, [cc % P for cc in carries]


def rsa_advice(signature: int, modulus: int, ns: str = "rsa") -> dict:
    """All hint inputs for rsa_verifier_65537, keyed by input name.

    Returns python-int nested lists; stack across the email batch and convert
    with `stack_advice` before feeding the witness evaluator.
    """
    qs, rs, cs_ = [], [], []
    x = signature
    for i in range(16):
        ql, rl, carr = fp_mul_advice(x, x, modulus)
        x = (x * x) % modulus
        qs.append(ql)
        rs.append(rl)
        cs_.append(carr)
    ql, rl, carr = fp_mul_advice(x, signature, modulus)
    qs.append(ql)
    rs.append(rl)
    cs_.append(carr)
    return {f"{ns}/q": qs, f"{ns}/r": rs, f"{ns}/carries": cs_}


def stack_advice(batch_advice: list[dict]) -> dict:
    """List of per-email advice dicts -> {name: (L, *shape, B) int32 limbs}."""
    out = {}
    for name in batch_advice[0]:
        arrs = np.array([a[name] for a in batch_advice], dtype=object)  # (B, ...)
        arrs = np.moveaxis(arrs, 0, -1)  # (..., B)
        out[name] = LB.ints_to_limbs(arrs)
    return out
