"""Port field core (zkemail_tpu_torch.core.limbs, ops.field_kernels) against
the JAX package on the CPU: every comparison is exact, limb for limb."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.core import field as JF
from zkemail_tpu.core import limbs as JL
from zkemail_tpu.ops import pallas_field as PF
from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.towers import XI
from zkemail_tpu_torch.ops import field_kernels as FK

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "zkemail_tpu_torch" / "ops" / "csrc"


def _values(name, n, seed):
    """Edge values 0, 1, p-1, p-2, R mod p, 2, then seeded random ones."""
    spec = JL.FieldSpec.make(name)
    rng = np.random.default_rng(seed)
    edge = [0, 1, spec.p - 1, spec.p - 2, JF.MONT_R % spec.p, 2]
    rand = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n - len(edge))]
    return np.array(edge + rand, dtype=object)


def _pair(name, n=200):
    a = JL.ints_to_limbs(_values(name, n, 1))
    b = JL.ints_to_limbs(_values(name, n, 2)[::-1].copy())
    return a, b


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_mont_mul_plain_equals_jax_and_pallas_interpret(name):
    a, b = _pair(name)
    js = JL.FieldSpec.make(name)
    ref = np.asarray(JL.mont_mul(js, jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(PF.mont_mul_flat(js, jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = LB.mont_mul(LB.FieldSpec.make(name), torch.from_numpy(a), torch.from_numpy(b))
    assert (out.numpy() == ref).all()
    assert (out.numpy() == pallas).all()


@pytest.mark.parametrize("name", ["Fq", "Fr"])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_equal_jax(name, op):
    a, b = _pair(name)
    ref = np.asarray(getattr(JL, op)(JL.FieldSpec.make(name), jnp.asarray(a), jnp.asarray(b)))
    out = getattr(LB, op)(LB.FieldSpec.make(name), torch.from_numpy(a), torch.from_numpy(b))
    assert (out.numpy() == ref).all()


def test_neg_mont_conversions_equal_jax():
    a, _ = _pair("Fr")
    js, ts = JL.FR_SPEC, LB.FR_SPEC
    ta = torch.from_numpy(a)
    assert (LB.neg(ts, ta).numpy() == np.asarray(JL.neg(js, jnp.asarray(a)))).all()
    assert (LB.to_mont(ts, ta).numpy() == np.asarray(JL.to_mont(js, jnp.asarray(a)))).all()
    assert (LB.from_mont(ts, ta).numpy() == np.asarray(JL.from_mont(js, jnp.asarray(a)))).all()


def test_inverses_equal_jax():
    a = JL.ints_to_limbs(_values("Fq", 24, 3))
    js, ts = JL.FQ_SPEC, LB.FQ_SPEC
    ref = np.asarray(JL.inv(js, jnp.asarray(a)))
    assert (LB.inv(ts, torch.from_numpy(a)).numpy() == ref).all()
    ladder = LB.pow_const(ts, torch.from_numpy(a), ts.p - 2)  # what K1 runs
    assert (ladder.numpy() == ref).all()
    ref_b = np.asarray(JL.batch_inv(js, jnp.asarray(a)))
    assert (LB.batch_inv(ts, torch.from_numpy(a)).numpy() == ref_b).all()
    ref_p = np.asarray(JL.pow_const(js, jnp.asarray(a), 12345))
    assert (LB.pow_const(ts, torch.from_numpy(a), 12345).numpy() == ref_p).all()


def test_broadcasting_and_predicates():
    a, b = _pair("Fq", 6)
    ta = torch.from_numpy(a).reshape(F.LIMBS, 2, 3)
    tb = torch.from_numpy(b[:, :1]).reshape(F.LIMBS, 1, 1)
    ref = np.asarray(JL.mont_mul(JL.FQ_SPEC, jnp.asarray(a).reshape(F.LIMBS, 2, 3),
                                 jnp.asarray(b[:, :1]).reshape(F.LIMBS, 1, 1)))
    assert (LB.mont_mul(LB.FQ_SPEC, ta, tb).numpy() == ref).all()
    z = torch.from_numpy(a)
    assert LB.is_zero(z).tolist() == [True] + [False] * 5
    assert LB.eq(z, z).all()
    sel = LB.select(torch.tensor([True, False] * 3), z, torch.zeros_like(z))
    assert (sel[:, 1::2] == 0).all() and (sel[:, ::2] == z[:, ::2]).all()


def test_limb_conversion_roundtrip_equals_jax():
    vals = _values("Fq", 50, 4)
    limbs = LB.ints_to_limbs(vals)
    assert (limbs == JL.ints_to_limbs(vals)).all()
    assert list(LB.limbs_to_ints(torch.from_numpy(limbs))) == list(vals)


def test_header_constants_match_field():
    """The moduli written into ops/csrc/field.cuh (12-bit limbs), and the
    plain versions' G2 b3 limbs."""
    text = (CSRC / "field.cuh").read_text()

    def arr(name):
        body = re.search(name + r"\[L\] = \{([^}]*)\}", text).group(1)
        return [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]

    assert arr("FQ_P") == F.to_limbs(F.FQ.p)
    assert arr("FR_P") == F.to_limbs(F.FR.p)
    assert int(re.search(r"FQ_N0INV = (\d+)", text).group(1)) == F.FQ.n0inv
    assert int(re.search(r"FR_N0INV = (\d+)", text).group(1)) == F.FR.n0inv
    limbs = PF._g2_b3_mont_limbs()
    assert tuple(map(tuple, limbs)) == FK._g2_b3_limbs()


def test_field32_constants_match_field():
    """The constants of ops/csrc/field32.cuh (8 x 32-bit words, R' = 2^256)
    against the port's field module and the JAX package's."""
    text = (CSRC / "field32.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", text).group(1)
        ws = [int(x, 16) for x in body.replace("\n", " ").split(",") if x.strip()]
        assert len(ws) == 8
        return sum(w << (32 * i) for i, w in enumerate(ws))

    p_words = [int(re.search(rf'#define ZK_FQ_P{i} "(0x[0-9a-f]+)"', text).group(1), 16)
               for i in range(8)]
    assert all(w < 1 << 32 for w in p_words)
    assert sum(w << (32 * i) for i, w in enumerate(p_words)) == F.FQ.p == JF.Q
    np0 = int(re.search(r"FQ_NP0 = (0x[0-9a-f]+)u;", text).group(1), 16)
    assert np0 == -pow(JF.Q, -1, 1 << 32) % (1 << 32)
    assert np0 % (1 << 8) == -pow(F.Q, -1, 1 << 8) % (1 << 8)  # load_fq's factor
    assert int(re.search(r"FQ_P7_PLUS_1 = (0x[0-9a-f]+)ull;", text).group(1), 16) == (
        (F.Q >> 224) + 1)
    # b3 in R' form from the port's towers, and from the JAX kernel's limbs
    # (b3 * 2^264 mod p) times 2^-8
    b3 = XI.inv() * 9
    c0, c1 = words("G2_B3_R256_C0"), words("G2_B3_R256_C1")
    assert (c0, c1) == tuple(int(c) * (1 << 256) % F.Q for c in (b3.c0, b3.c1))
    jax_b3 = tuple(F.from_limbs(l) * pow(2, -8, JF.Q) % JF.Q for l in PF._g2_b3_mont_limbs())
    assert (c0, c1) == jax_b3
    assert words("G2_B3_R256_SUM") == (c0 + c1) % F.Q


def test_fr32_constants_match_field():
    """The constants of ops/csrc/fr32.cuh (K4's Fr on 8 x 32-bit words)
    against the port's field module and the JAX package's."""
    text = (CSRC / "fr32.cuh").read_text()
    p_words = [int(re.search(rf'#define ZK_FR_P{i} "(0x[0-9a-f]+)"', text).group(1), 16)
               for i in range(8)]
    assert all(w < 1 << 32 for w in p_words)
    assert sum(w << (32 * i) for i, w in enumerate(p_words)) == F.FR.p == JF.R
    np0 = int(re.search(r"FR_NP0 = (0x[0-9a-f]+)u;", text).group(1), 16)
    assert np0 == -pow(JF.R, -1, 1 << 32) % (1 << 32)
    assert np0 % (1 << F.LIMB_BITS) == F.FR.n0inv


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    a, b = _pair("Fr", 8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = dict(FK.LAUNCHES)
    FK.mont_mul_flat("Fr", ta, tb)
    assert FK.LAUNCHES == before  # the CPU runs the plain version
    with pytest.raises(ValueError):
        FK.mont_mul_flat("Fr", ta.to(torch.int64), tb.to(torch.int64))
    with pytest.raises(ValueError):
        FK.mont_mul_flat("Fr", ta[:, ::2], tb[:, ::2])
    with pytest.raises(ValueError):
        FK.mont_mul_flat("Fr", ta[:20], tb[:20])
    p = {k: ta for k in "xyz"}
    with pytest.raises(ValueError):
        FK.ec_add_g1_flat(p, p, torch.zeros(3, dtype=torch.int32))


def test_field_module_is_a_copy_of_the_jax_one():
    assert F.Q == JF.Q and F.R == JF.R and F.LIMBS == JF.LIMBS
    assert F.FR_ROOT_OF_UNITY == JF.FR_ROOT_OF_UNITY
    assert all(F.fr_nth_root(k) == JF.fr_nth_root(k) for k in (1, 8, 21))

