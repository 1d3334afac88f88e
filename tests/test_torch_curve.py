"""Port curve layer (core.curve_torch and the plain versions of K2/K3)
against the JAX package on the CPU: exact limb equality, with identity
operands, doubling (P + P), P + (-P) and negated lanes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkemail_tpu.core import curve_jax as CJ
from zkemail_tpu.core.curve import G1, G2
from zkemail_tpu.ops import msm as JM
from zkemail_tpu.ops import pallas_field as PF
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.ops import field_kernels as FK

torch.set_num_threads(1)


def _operands(group, n, seed):
    """Host points a_i, b_i: b is the identity on i % 7 == 0, a_i on
    i % 5 == 0, -a_i on i % 11 == 0; neg set on i % 3 == 0."""
    gen = G1.generator() if group == "g1" else G2.generator()
    rng = np.random.default_rng(seed)
    pa, pb = [], []
    for i in range(n):
        a = gen.mul(int(rng.integers(1, 10**9)))
        if i % 7 == 0:
            b = type(gen).identity()
        elif i % 5 == 0:
            b = a
        elif i % 11 == 0:
            b = a.neg()
        else:
            b = gen.mul(int(rng.integers(1, 10**9)))
        pa.append(a)
        pb.append(b)
    neg = np.array([i % 3 == 0 for i in range(n)], dtype=np.int32)
    return pa, pb, neg


def _jax_points(group, pts):
    if group == "g1":
        return JM.points_from_affine_ints(
            CJ.FQ_OPS, [0 if p.inf else p.x for p in pts],
            [1 if p.inf else p.y for p in pts], [p.inf for p in pts])
    return JM.g2_points_from_affine(
        [p.x.c0 for p in pts], [p.x.c1 for p in pts], [p.y.c0 for p in pts],
        [p.y.c1 for p in pts], [p.inf for p in pts])


def _to_torch(pt):
    return {k: tuple(torch.from_numpy(np.array(c)) for c in v) if isinstance(v, tuple)
            else torch.from_numpy(np.array(v)) for k, v in pt.items()}


def _equal(port, ref):
    for k in ("x", "y", "z"):
        a, b = port[k], ref[k]
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            assert (x.numpy() == np.asarray(y)).all(), k


@pytest.mark.parametrize("group,n", [("g1", 60), ("g2", 24)])
def test_plain_kernel_adds_equal_jax(group, n):
    pa, pb, neg = _operands(group, n, 9)
    p, q = _jax_points(group, pa), _jax_points(group, pb)
    jops = CJ.FQ_OPS if group == "g1" else CJ.FQ2_OPS
    eager = PF.ec_add_g1_eager_math if group == "g1" else PF.ec_add_g2_eager_math
    plain = FK.ec_add_g1_flat if group == "g1" else FK.ec_add_g2_flat
    tp, tq = _to_torch(p), _to_torch(q)
    out = plain(tp, tq, torch.from_numpy(neg))
    _equal(out, eager(p, q, jnp.asarray(neg)))
    ref_q = CJ.ec_select(jops, jnp.asarray(neg) != 0, CJ.ec_neg(jops, q), q)
    _equal(out, CJ.ec_add(jops, p, ref_q))
    zero = np.zeros(n, dtype=np.int32)
    _equal(plain(tp, tq, torch.from_numpy(zero)), CJ.ec_add(jops, p, q))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_ops_equal_jax(group):
    pa, pb, neg = _operands(group, 12, 5)
    p, q = _jax_points(group, pa), _jax_points(group, pb)
    jops, tops = (CJ.FQ_OPS, CT.FQ_OPS) if group == "g1" else (CJ.FQ2_OPS, CT.FQ2_OPS)
    tp, tq = _to_torch(p), _to_torch(q)
    # the doubling of the MSMs' Horner loops is the complete addition P + P
    dbl = CT.ec_to_affine(tops, CT.ec_add(tops, tp, tp))
    jdbl = CJ.ec_to_affine(jops, CJ.ec_double(jops, p))
    _equal({"x": dbl["x"], "y": dbl["y"], "z": dbl["x"]},
           {"x": jdbl["x"], "y": jdbl["y"], "z": jdbl["x"]})
    _equal(CT.ec_add_signed(tops, tp, tq, torch.from_numpy(neg)),
           CJ.ec_add_signed(jops, p, q, jnp.asarray(neg)))
    _equal(CT.ec_neg(tops, tp), CJ.ec_neg(jops, p))
    aff, jaff = CT.ec_to_affine(tops, tp), CJ.ec_to_affine(jops, p)
    _equal({"x": aff["x"], "y": aff["y"], "z": aff["x"]},
           {"x": jaff["x"], "y": jaff["y"], "z": jaff["x"]})
    assert (aff["inf"].numpy() == np.asarray(jaff["inf"])).all()


def test_broadcast_add_and_identity():
    pa, _, _ = _operands("g1", 6, 3)
    p = _to_torch(_jax_points("g1", pa))
    ident = CT.ec_identity(CT.FQ_OPS, (), "cpu")
    out = CT.ec_add(CT.FQ_OPS, p, ident)  # (n,) + () broadcasts
    aff_o, aff_p = CT.ec_to_affine(CT.FQ_OPS, out), CT.ec_to_affine(CT.FQ_OPS, p)
    assert (aff_o["x"] == aff_p["x"]).all() and (aff_o["y"] == aff_p["y"]).all()
    pp = {k: v.reshape(22, 2, 3) for k, v in p.items()}
    out2 = CT.ec_add(CT.FQ_OPS, pp, pp)
    dbl = CT.ec_add(CT.FQ_OPS, p, p)
    aff_a = CT.ec_to_affine(CT.FQ_OPS, {k: v.reshape(22, 6) for k, v in out2.items()})
    aff_b = CT.ec_to_affine(CT.FQ_OPS, dbl)
    assert (aff_a["x"] == aff_b["x"]).all() and (aff_a["y"] == aff_b["y"]).all()


def test_fq2_inverse_and_b3_equal_jax():
    pa, _, _ = _operands("g2", 6, 4)
    p = _jax_points("g2", pa)
    tp = _to_torch(p)
    inv = CT.FQ2_OPS.inv(tp["x"])
    jinv = CJ.FQ2_OPS.inv(p["x"])
    for c in (0, 1):
        assert (inv[c].numpy() == np.asarray(jinv[c])).all()
