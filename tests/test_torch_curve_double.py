"""The port's ec_double and ec_scalar_mul_bits (core/curve_torch.py), both
complete additions through K2/K3 (their plain versions here), against the
JAX package's curve_jax on the CPU: affine points compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkemail_tpu.core import curve_jax as CJ
from zkemail_tpu.core import field as JF
from zkemail_tpu.core.curve import G1, G2
from zkemail_tpu.ops import msm as JM
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.core import limbs as LB

torch.set_num_threads(1)


def _g1_points(n, seed):
    rng = np.random.default_rng(seed)
    g = G1.generator()
    pts = [g.mul(int(rng.integers(1, 10**9))) for _ in range(n - 1)] + [G1.identity()]
    jp = JM.points_from_affine_ints(
        CJ.FQ_OPS, [0 if p.inf else p.x for p in pts], [1 if p.inf else p.y for p in pts],
        [p.inf for p in pts])
    return pts, jp


def _g2_points(n, seed):
    rng = np.random.default_rng(seed)
    g = G2.generator()
    pts = [g.mul(int(rng.integers(1, 10**9))) for _ in range(n - 1)] + [G2.identity()]
    jp = JM.g2_points_from_affine(
        [p.x.c0 for p in pts], [p.x.c1 for p in pts], [p.y.c0 for p in pts],
        [p.y.c1 for p in pts], [p.inf for p in pts])
    return pts, jp


def _to_torch(pt):
    return {k: tuple(torch.from_numpy(np.array(c)) for c in v) if isinstance(v, tuple)
            else torch.from_numpy(np.array(v)) for k, v in pt.items()}


def _affine_equal(port_ops, port, jax_ops, ref):
    a, b = CT.ec_to_affine(port_ops, port), CJ.ec_to_affine(jax_ops, ref)
    for k in ("x", "y"):
        pairs = zip(a[k], b[k]) if isinstance(a[k], tuple) else [(a[k], b[k])]
        for x, y in pairs:
            assert (x.numpy() == np.asarray(y)).all(), k
    assert (a["inf"].numpy() == np.asarray(b["inf"])).all()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ec_double_equals_jax(group):
    pts, jp = (_g1_points if group == "g1" else _g2_points)(5, 3)
    tops, jops = (CT.FQ_OPS, CJ.FQ_OPS) if group == "g1" else (CT.FQ2_OPS, CJ.FQ2_OPS)
    _affine_equal(tops, CT.ec_double(tops, _to_torch(jp)), jops, CJ.ec_double(jops, jp))


def test_ec_scalar_mul_bits_equals_jax():
    pts, jp = _g1_points(6, 4)
    rng = np.random.default_rng(5)
    nbits = 16
    scalars = [int(s) for s in rng.integers(0, 1 << nbits, size=len(pts))]
    scalars[0] = 0
    bits = np.array([[(s >> (nbits - 1 - i)) & 1 for s in scalars] for i in range(nbits)],
                    dtype=np.int32)
    got = CT.ec_scalar_mul_bits(CT.FQ_OPS, _to_torch(jp), torch.from_numpy(bits))
    _affine_equal(CT.FQ_OPS, got, CJ.FQ_OPS,
                  CJ.ec_scalar_mul_bits(CJ.FQ_OPS, jp, jnp.asarray(bits)))
    aff = CT.ec_to_affine(CT.FQ_OPS, got)
    xs, ys = CT.FQ_OPS.to_ints(aff["x"]), CT.FQ_OPS.to_ints(aff["y"])
    for i, (p, s) in enumerate(zip(pts, scalars)):
        want = p.mul(s)
        assert bool(aff["inf"][i]) == want.inf
        if not want.inf:
            assert (int(xs[i]), int(ys[i])) == (want.x, want.y)


def test_ec_scalar_mul_bits_g2():
    pts, jp = _g2_points(3, 6)
    scalars = [5, 0, 3]
    bits = np.array([[(s >> (2 - i)) & 1 for s in scalars] for i in range(3)], dtype=np.int32)
    got = CT.ec_to_affine(CT.FQ2_OPS, CT.ec_scalar_mul_bits(
        CT.FQ2_OPS, _to_torch(jp), torch.from_numpy(bits)))
    want = [p.mul(s) for p, s in zip(pts, scalars)]
    for i, w in enumerate(want):
        assert bool(got["inf"][i]) == w.inf
        if not w.inf:
            x = [int(JF.FQ.from_mont(int(v))) for v in (
                LB.limbs_to_ints(got["x"][0][:, i:i + 1])[0],
                LB.limbs_to_ints(got["x"][1][:, i:i + 1])[0])]
            assert x == [w.x.c0, w.x.c1]
