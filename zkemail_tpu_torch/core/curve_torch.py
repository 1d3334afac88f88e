"""Batched BN254 point arithmetic on PyTorch tensors — complete formulas.

The port of ``zkemail_tpu/core/curve_jax.py``: Renes–Costello–Batina
complete projective addition for a = 0 curves (Alg. 7), so a batch of
point operations runs with identity and doubling handled uniformly.

Points are dicts {x, y, z} of field coordinates; a coordinate is an (L, ...)
int32 limb tensor in Montgomery form for Fq (G1) or a (c0, c1) tuple of them
for Fq2 (G2). Identity is (0, 1, 0).

``ec_add`` and ``ec_add_signed`` go to the fused kernels at any lane count:
K2 (``ops/csrc/ec_add_g1.cu``) for G1 and K3 (``ops/csrc/ec_add_g2.cu``)
for G2 on a CUDA tensor, their plain versions on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..ops import field_kernels as FK
from . import field as F
from . import limbs as LB

L = F.LIMBS


class FqOps:
    """Fq operations (G1 coordinate field)."""

    name = "fq"
    fs = LB.FQ_SPEC

    def mul(self, a, b):
        return LB.mont_mul(self.fs, a, b)

    def add(self, a, b):
        return LB.add(self.fs, a, b)

    def sub(self, a, b):
        return LB.sub(self.fs, a, b)

    def neg(self, a):
        return LB.neg(self.fs, a)

    def zero(self, shape, device):
        return LB.zeros(shape, device)

    def one(self, shape, device):
        return LB.constant(self.fs, 1, shape, device)

    def select(self, cond, a, b):
        return LB.select(cond, a, b)

    def is_zero(self, a):
        return LB.is_zero(a)

    def inv(self, a):
        return LB.inv(self.fs, a)

    def batch_shape(self, a):
        return tuple(a.shape[1:])

    def device(self, a):
        return a.device

    def from_ints(self, values, device):
        """Python ints -> (L, *shape) Montgomery limbs on `device`."""
        return fq_from(values, device)

    def to_ints(self, a):
        """Montgomery limbs -> object ndarray of the Python ints they hold."""
        out = LB.limbs_to_ints(a)
        flat = [F.FQ.from_mont(int(v)) for v in out.reshape(-1)]
        return _obj_array(flat).reshape(out.shape)


class Fq2Ops:
    """Fq2 = Fq[u]/(u^2+1) operations (G2 coordinate field)."""

    name = "fq2"
    fs = LB.FQ_SPEC

    def mul(self, a, b):
        a0, a1 = a
        b0, b1 = b
        t0 = LB.mont_mul(self.fs, a0, b0)
        t1 = LB.mont_mul(self.fs, a1, b1)
        s = LB.mont_mul(self.fs, LB.add(self.fs, a0, a1), LB.add(self.fs, b0, b1))
        c0 = LB.sub(self.fs, t0, t1)
        c1 = LB.sub(self.fs, LB.sub(self.fs, s, t0), t1)
        return (c0, c1)

    def add(self, a, b):
        return (LB.add(self.fs, a[0], b[0]), LB.add(self.fs, a[1], b[1]))

    def sub(self, a, b):
        return (LB.sub(self.fs, a[0], b[0]), LB.sub(self.fs, a[1], b[1]))

    def neg(self, a):
        return (LB.neg(self.fs, a[0]), LB.neg(self.fs, a[1]))

    def zero(self, shape, device):
        return (LB.zeros(shape, device), LB.zeros(shape, device))

    def one(self, shape, device):
        return (LB.constant(self.fs, 1, shape, device), LB.zeros(shape, device))

    def select(self, cond, a, b):
        return (LB.select(cond, a[0], b[0]), LB.select(cond, a[1], b[1]))

    def is_zero(self, a):
        return LB.is_zero(a[0]) & LB.is_zero(a[1])

    def inv(self, a):
        a0, a1 = a
        norm = LB.add(
            self.fs, LB.mont_mul(self.fs, a0, a0), LB.mont_mul(self.fs, a1, a1)
        )
        ninv = LB.inv(self.fs, norm)
        return (
            LB.mont_mul(self.fs, a0, ninv),
            LB.neg(self.fs, LB.mont_mul(self.fs, a1, ninv)),
        )

    def batch_shape(self, a):
        return tuple(a[0].shape[1:])

    def device(self, a):
        return a[0].device


def _obj_array(values):
    import numpy as np

    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def fq_from(vals, device) -> torch.Tensor:
    """Python ints -> (L, *shape) Montgomery Fq limbs on `device`."""
    import numpy as np

    arr = np.asarray(vals, dtype=object)
    arr = _obj_array([F.FQ.to_mont(int(v)) for v in arr.reshape(-1)]).reshape(arr.shape)
    return LB.to_device(LB.ints_to_limbs(arr), device)


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()


# ---------------------------------------------------------------------------
# Complete group law (RCB 2015, a = 0)
# ---------------------------------------------------------------------------

def ec_identity(ops, shape, device):
    return {"x": ops.zero(shape, device), "y": ops.one(shape, device),
            "z": ops.zero(shape, device)}


def ec_is_identity(ops, p):
    return ops.is_zero(p["z"])


def ec_neg(ops, p):
    return {"x": p["x"], "y": ops.neg(p["y"]), "z": p["z"]}


def ec_select(ops, cond, p, q):
    return {k: ops.select(cond, p[k], q[k]) for k in ("x", "y", "z")}


def _fused_add(ops, p, q, neg):
    """p + (neg != 0 ? -q : q) through K2/K3 (or their plain versions) on
    the broadcast batch shape, flattened to (L, n) lanes."""
    shape = torch.broadcast_shapes(ops.batch_shape(p["x"]), ops.batch_shape(q["x"]))
    n = 1
    for d in shape:
        n *= d

    def flat(c):
        return LB.expand_batch(c, shape).reshape(L, n).contiguous()

    def flat_pt(pt):
        if ops.name == "fq2":
            return {k: (flat(v[0]), flat(v[1])) for k, v in pt.items() if k in "xyz"}
        return {k: flat(v) for k, v in pt.items() if k in "xyz"}

    device = ops.device(p["x"])
    if neg is None:
        negf = torch.zeros((n,), dtype=torch.int32, device=device)
    else:
        negf = neg.to(torch.int32).expand(shape).reshape(n).contiguous()
    fused = FK.ec_add_g1_flat if ops.name == "fq" else FK.ec_add_g2_flat
    out = fused(flat_pt(p), flat_pt(q), negf)

    def unflat(c):
        return c.reshape((L,) + tuple(shape))

    if ops.name == "fq2":
        return {k: (unflat(v[0]), unflat(v[1])) for k, v in out.items()}
    return {k: unflat(v) for k, v in out.items()}


def ec_add_signed(ops, p, q, neg):
    """p + (neg != 0 ? -q : q) — the MSM inner op, the negation fused into
    the addition kernel."""
    return _fused_add(ops, p, q, neg)


def ec_add(ops, p, q):
    """Complete projective addition, RCB Algorithm 7 (a = 0)."""
    return _fused_add(ops, p, q, None)


def ec_double(ops, p):
    """2P as the complete addition P + P (one K2/K3 launch): the addition
    law is complete, so it doubles too. The JAX package's dedicated
    doubling (RCB Algorithm 9) may give another projective representative
    of the same point."""
    return _fused_add(ops, p, p, None)


def ec_scalar_mul_bits(ops, p, scalar_bits: torch.Tensor):
    """Batched double-and-add: scalar_bits (nbits, ...) int32, MSB first,
    each row shaped like p's batch. Two K2/K3 launches per bit."""
    acc = ec_identity(ops, ops.batch_shape(p["x"]), ops.device(p["x"]))
    for bit in scalar_bits:
        acc = ec_double(ops, acc)
        acc = ec_select(ops, bit != 0, ec_add(ops, acc, p), acc)
    return acc


def ec_to_affine(ops, p):
    """Normalize projective -> affine (identity maps to (0, 0))."""
    zinv = ops.inv(p["z"])
    return {
        "x": ops.mul(p["x"], zinv),
        "y": ops.mul(p["y"], zinv),
        "inf": ec_is_identity(ops, p),
    }
