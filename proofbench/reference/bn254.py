"""BN254 in pure Python: Fq2/Fq6/Fq12 towers, affine G1/G2 and the optimal
ate pairing, for judging Groth16 proofs.

A frozen copy of ``zkemail_tpu_torch/core/towers.py`` and ``core/curve.py``
(themselves copies of the JAX package's verifier oracle), cut to what a
verifier needs, so that the benchmark's reference imports nothing of the
program. Slow and plain on purpose: one Miller loop takes about 0.3 s.
"""

from __future__ import annotations

from dataclasses import dataclass

BN254_X = 4965661367192848881
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
assert Q == 36 * BN254_X**4 + 36 * BN254_X**3 + 24 * BN254_X**2 + 6 * BN254_X + 1
assert R == 36 * BN254_X**4 + 36 * BN254_X**3 + 18 * BN254_X**2 + 6 * BN254_X + 1


@dataclass(frozen=True)
class Fq2:
    c0: int
    c1: int

    def __add__(self, o):
        return Fq2((self.c0 + o.c0) % Q, (self.c1 + o.c1) % Q)

    def __sub__(self, o):
        return Fq2((self.c0 - o.c0) % Q, (self.c1 - o.c1) % Q)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o % Q, self.c1 * o % Q)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)

    def __neg__(self):
        return Fq2((-self.c0) % Q, (-self.c1) % Q)

    def sq(self):
        a0, a1 = self.c0, self.c1
        return Fq2((a0 + a1) * (a0 - a1) % Q, 2 * a0 * a1 % Q)

    def inv(self):
        n_inv = pow((self.c0 * self.c0 + self.c1 * self.c1) % Q, -1, Q)
        return Fq2(self.c0 * n_inv % Q, (-self.c1) * n_inv % Q)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __pow__(self, e: int):
        out, base = FQ2_ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(9, 1)  # the sextic twist's residue


@dataclass(frozen=True)
class Fq6:
    c0: Fq2
    c1: Fq2
    c2: Fq2

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, (int, Fq2)):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        return Fq6(t0 + XI * ((a1 + a2) * (b1 + b2) - t1 - t2),
                   (a0 + a1) * (b0 + b1) - t0 - t1 + XI * t2,
                   (a0 + a2) * (b0 + b2) - t0 - t2 + t1)

    def mul_by_v(self):
        return Fq6(XI * self.c2, self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sq() - XI * (a1 * a2)
        t1 = XI * a2.sq() - a0 * a1
        t2 = a1.sq() - a0 * a2
        d = (a0 * t0 + XI * (a2 * t1 + a1 * t2)).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


@dataclass(frozen=True)
class Fq12:
    c0: Fq6
    c1: Fq6

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0, t1 = a0 * b0, a1 * b1
        return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def sq(self):
        return self * self

    def inv(self):
        d = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fq12(self.c0 * d, -(self.c1 * d))

    def __pow__(self, e: int):
        out, base = FQ12_ONE, self
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out


FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


def _fq12(x: Fq2, power_of_w: int) -> Fq12:
    """x * w^k in Fq12 (w^2 = v)."""
    coeffs = [[FQ2_ZERO] * 3, [FQ2_ZERO] * 3]
    coeffs[power_of_w % 2][power_of_w // 2] = x
    return Fq12(Fq6(*coeffs[0]), Fq6(*coeffs[1]))


B_G1 = 3
B_G2 = Fq2(3, 0) * XI.inv()
G2_GEN_XY = (
    Fq2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    Fq2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


@dataclass(frozen=True)
class G1:
    x: int
    y: int
    inf: bool = False

    def on_curve(self) -> bool:
        return self.inf or (self.y * self.y - self.x ** 3 - B_G1) % Q == 0

    def neg(self):
        return self if self.inf else G1(self.x, (-self.y) % Q)

    def add(self, o: "G1") -> "G1":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y) % Q == 0:
                return G1_ZERO
            lam = 3 * self.x * self.x * pow(2 * self.y, -1, Q) % Q
        else:
            lam = (o.y - self.y) * pow(o.x - self.x, -1, Q) % Q
        x3 = (lam * lam - self.x - o.x) % Q
        return G1(x3, (lam * (self.x - x3) - self.y) % Q)

    def mul(self, k: int) -> "G1":
        k %= R
        acc, base = G1_ZERO, self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.add(base)
            k >>= 1
        return acc


G1_ZERO = G1(0, 0, True)
G1_GEN = G1(1, 2)


@dataclass(frozen=True)
class G2:
    x: Fq2
    y: Fq2
    inf: bool = False

    def on_curve(self) -> bool:
        return self.inf or self.y.sq() == self.x * self.x * self.x + B_G2

    def add(self, o: "G2") -> "G2":
        if self.inf:
            return o
        if o.inf:
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2_ZERO
            lam = self.x.sq() * 3 * (self.y * 2).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.sq() - self.x - o.x
        return G2(x3, lam * (self.x - x3) - self.y)

    def mul(self, k: int) -> "G2":
        acc, base = G2_ZERO, self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.add(base)
            k >>= 1
        return acc

    def in_subgroup(self) -> bool:
        return self.mul(R).inf


G2_ZERO = G2(FQ2_ZERO, FQ2_ZERO, True)
G2_GEN = G2(*G2_GEN_XY)

ATE_LOOP_COUNT = 6 * BN254_X + 2
FINAL_EXP = (Q ** 12 - 1) // R


def _line(ax, ay, bx, by, px, py):
    """The line through A and B (the tangent when A == B) at P, and A + B."""
    if ax == bx and ay == by:
        lam = ax.sq() * 3 * (ay * 2).inv()
    elif ax == bx:  # vertical
        return px - ax, (None, None)
    else:
        lam = (by - ay) * (bx - ax).inv()
    x3 = lam.sq() - ax - bx
    return py - ay - lam * (px - ax), (x3, lam * (ax - x3) - ay)


def miller_loop(p: G1, q: G2) -> Fq12:
    if p.inf or q.inf:
        return FQ12_ONE
    qx, qy = _fq12(q.x, 2), _fq12(q.y, 3)
    px, py = _fq12(Fq2(p.x, 0), 0), _fq12(Fq2(p.y, 0), 0)
    tx, ty, f = qx, qy, FQ12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        val, (tx, ty) = _line(tx, ty, tx, ty, px, py)
        f = f.sq() * val
        if bit == "1":
            val, (tx, ty) = _line(tx, ty, qx, qy, px, py)
            f = f * val
    q1x, q1y = qx ** Q, qy ** Q
    q2x, q2y = q1x ** Q, q1y ** Q
    val, (tx, ty) = _line(tx, ty, q1x, q1y, px, py)
    f = f * val
    val, _ = _line(tx, ty, q2x, -q2y, px, py)
    return f * val


def pairing_product_is_one(pairs: list) -> bool:
    """prod e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return f ** FINAL_EXP == FQ12_ONE
