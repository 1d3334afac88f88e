"""Port MSMs (zkemail_tpu_torch.ops.msm) against the JAX package on the CPU:
the signed digits at the bucket route's c = 8 and the sort route's wider
windows, the batched bucket MSM (B = 2, one scalar vector all zero,
n % 16 != 0) and the fixed-base multiplication of the setup on G1 and G2."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkemail_tpu.core import curve_jax as CJ
from zkemail_tpu.core import limbs as JL
from zkemail_tpu.core.curve import G1
from zkemail_tpu.ops import msm as JM
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.ops import msm as TM

torch.set_num_threads(1)

N = 150  # n % 16 != 0


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % JL.FR_SPEC.p for _ in range(n)]


def _affine_ints(ops_mod, ops, pt):
    aff = ops_mod.ec_to_affine(ops, pt)
    if isinstance(aff["x"], tuple):
        coords = [aff["x"][0], aff["x"][1], aff["y"][0], aff["y"][1]]
    else:
        coords = [aff["x"], aff["y"]]
    limbs = [np.asarray(c.numpy() if isinstance(c, torch.Tensor) else c) for c in coords]
    inf = aff["inf"].numpy() if isinstance(aff["inf"], torch.Tensor) else np.asarray(aff["inf"])
    return [list(JL.limbs_to_ints(c)) for c in limbs], list(inf)


def test_signed_digits_equal_jax():
    s = JL.ints_to_limbs(np.array(_scalars(40, 1) + [0, JL.FR_SPEC.p - 1], dtype=object))
    mag, neg = TM.extract_signed_digits(torch.from_numpy(s))
    jmag, jneg = JM.extract_signed_digits(jnp.asarray(s))
    assert (mag.numpy() == np.asarray(jmag)).all() and (neg.numpy() == np.asarray(jneg)).all()
    d = TM.extract_digits_unsigned(torch.from_numpy(s))
    assert (d.numpy() == np.asarray(JM.extract_digits_unsigned(jnp.asarray(s)))).all()


@pytest.mark.parametrize("c_bits", [8, 12, 13, 16])
def test_signed_digits_wide_windows_equal_jax(c_bits):
    """The digits of the sort route's windows (c = 13 by default): equal to
    the JAX package's and reconstructing the scalar."""
    nw = -(-254 // c_bits)
    vals = _scalars(6, 2) + [0, 1, JL.FR_SPEC.p - 1, 1 << c_bits, (1 << (c_bits - 1)) + 1]
    s = JL.ints_to_limbs(np.array(vals, dtype=object))
    mag, neg = TM.extract_signed_digits(torch.from_numpy(s), c_bits, nw)
    jmag, jneg = JM.extract_signed_digits(jnp.asarray(s), c_bits, nw)
    assert (mag.numpy() == np.asarray(jmag)).all() and (neg.numpy() == np.asarray(jneg)).all()
    d = (1 - 2 * neg.numpy().astype(np.int64)) * mag.numpy().astype(np.int64)
    for i, v in enumerate(vals):
        assert sum(int(d[k, i]) << (c_bits * k) for k in range(nw)) == v


def test_msm_multi_equals_jax_and_host():
    rng = np.random.default_rng(7)
    pts = [G1.generator().mul(int(rng.integers(1, 10**9))) for _ in range(N)]
    jpts = JM.points_from_affine_ints(CJ.FQ_OPS, [p.x for p in pts], [p.y for p in pts], [False] * N)
    tpts = TM.points_from_affine_ints(CT.FQ_OPS, [p.x for p in pts], [p.y for p in pts],
                                      [False] * N, "cpu")
    for k in ("x", "y", "z"):
        assert (tpts[k].numpy() == np.asarray(jpts[k])).all()
    sc = _scalars(N, 8)
    limbs = JL.ints_to_limbs(np.array([sc, [0] * N], dtype=object))  # (L, 2, N)
    ref = JM.msm_multi(CJ.FQ_OPS, jpts, jnp.asarray(limbs))
    out = TM.msm_multi(CT.FQ_OPS, tpts, torch.from_numpy(limbs))
    ours = _affine_ints(CT, CT.FQ_OPS, out)
    assert ours == _affine_ints(CJ, CJ.FQ_OPS, ref)
    host = G1.identity()
    for s, p in zip(sc, pts):
        host = host.add(p.mul(s))
    mont = [F.FQ.to_mont(host.x), F.FQ.to_mont(host.y)]  # affine limbs stay Montgomery
    assert ours == ([[mont[0], 0], [mont[1], 0]], [False, True])


@pytest.mark.parametrize("kind,n", [("g1", N), ("g2", 40)])
def test_fixed_base_equals_jax(kind, n):
    sc = _scalars(n - 1, 9) + [0]
    ref = JM.fixed_base_batch(kind, sc)
    out = TM.fixed_base_batch(kind, torch.from_numpy(JL.ints_to_limbs(np.array(sc, dtype=object))))
    for k in ("x", "y", "z"):
        pairs = zip(out[k], ref[k]) if kind == "g2" else [(out[k], ref[k])]
        for a, b in pairs:
            assert (a.numpy() == np.asarray(b)).all(), k
