"""The port's sort/telescope MSM (zkemail_tpu_torch.ops.msm_sort) on the CPU.

Most cases are held to the port's bucket msm_multi and to sums of host
points (core/curve.py), at toy sizes: K = 4 and a cutoff of 4, which force
three or more telescope levels, c = 8 and c = 13, duplicate runs, the
scalars 0, 1 and p - 1, an identity point, column slices with a short last
slice, the zero vector, G2, the window-pruned MSM under a signal plan, a
stale plan, and the bit-serial MSM with and without a plan at widths that
are not a multiple of K. A few are held to the JAX package's msm_sorted,
build_signal_plan, msm_sorted_pruned and msm_bitserial on the same seeded
inputs, as affine points, exactly (its msm_sorted at c = 13 frozen by
tests/make_jax_reference.py). The window a width takes (window_bits) is 13
at every width of the benchmark's MSMs. Every comparison is exact
equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_jax_reference as JR
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.core import curve_jax as CJ
from zkemail_tpu.core import limbs as JL
from zkemail_tpu.ops import msm_sort as JS
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.core.curve import G1, G2
from zkemail_tpu_torch.core.towers import Fq2
from zkemail_tpu_torch.ops import msm as TM
from zkemail_tpu_torch.ops import msm_sort as MS

torch.set_num_threads(1)

P = F.R


def _rng(seed):
    return random.Random(seed)


def _g1_points(n, seed, identity_at=None):
    rng = _rng(seed)
    host = [G1.generator().mul(rng.randrange(1, 10**9)) for _ in range(n)]
    if identity_at is not None:
        host[identity_at] = G1.identity()
    pts = TM.points_from_affine_ints(
        CT.FQ_OPS, [0 if p.inf else p.x for p in host], [1 if p.inf else p.y for p in host],
        [p.inf for p in host], "cpu")
    return host, pts


def _g2_points(n, seed):
    rng = _rng(seed)
    host = [G2.generator().mul(rng.randrange(1, 10**9)) for _ in range(n)]
    pts = TM.g2_points_from_affine(
        [p.x.c0 for p in host], [p.x.c1 for p in host],
        [p.y.c0 for p in host], [p.y.c1 for p in host], device="cpu")
    return host, pts


def _limbs(rows):
    return JL.ints_to_limbs(np.array(rows, dtype=object))  # (L, B, n)


def _witness_like(n, seed):
    """Columns like a witness: zeros, bits and bytes, some 121-bit and some
    full-field values; p - 1 and 2^13 (a digit that fills its window)."""
    rng = _rng(seed)
    cols = []
    for _ in range(n):
        r = rng.random()
        cols.append(0 if r < 0.1 else rng.randrange(256) if r < 0.8
                    else rng.randrange(1 << 121) if r < 0.9 else rng.randrange(P))
    cols[0], cols[1] = P - 1, 1 << 13
    return [cols, [(v * 3) % P for v in cols]]


def _host_sums(host, rows, zero):
    out = []
    for row in rows:
        acc = zero
        for s, p in zip(row, host):
            acc = acc.add(p.mul(s))
        out.append(acc)
    return out


def _to_host(ops, pt):
    """A port point batch (B,) -> host points."""
    aff = CT.ec_to_affine(ops, pt)
    inf = aff["inf"].numpy()
    fq = CT.FQ_OPS
    if ops is CT.FQ_OPS:
        xs, ys = fq.to_ints(aff["x"]), fq.to_ints(aff["y"])
        return [G1.identity() if inf[i] else G1(int(xs[i]), int(ys[i])) for i in range(len(inf))]
    x0, x1 = fq.to_ints(aff["x"][0]), fq.to_ints(aff["x"][1])
    y0, y1 = fq.to_ints(aff["y"][0]), fq.to_ints(aff["y"][1])
    return [G2.identity() if inf[i] else G2(Fq2(int(x0[i]), int(x1[i])), Fq2(int(y0[i]), int(y1[i])))
            for i in range(len(inf))]


def _jax_to_host(ops, pt):
    """A JAX point batch (B,) -> host points, through numpy limbs."""
    aff = CJ.ec_to_affine(ops, pt)
    inf = np.asarray(aff["inf"]).reshape(-1)

    def ints(c):
        return [F.FQ.from_mont(int(v)) for v in JL.limbs_to_ints(np.asarray(c).reshape(F.LIMBS, -1))]

    if ops is CJ.FQ_OPS:
        xs, ys = ints(aff["x"]), ints(aff["y"])
        return [G1.identity() if inf[i] else G1(xs[i], ys[i]) for i in range(len(inf))]
    x0, x1, y0, y1 = (ints(c) for c in (*aff["x"], *aff["y"]))
    return [G2.identity() if inf[i] else G2(Fq2(x0[i], x1[i]), Fq2(y0[i], y1[i]))
            for i in range(len(inf))]


def _jax_points(pts):
    return {k: tuple(jnp.asarray(c.numpy()) for c in v) if isinstance(v, tuple)
            else jnp.asarray(v.numpy()) for k, v in pts.items()}


def _permuted(pts, perm):
    return TM.map_coords(pts, lambda c: c[:, torch.as_tensor(perm)])


# ---------------------------------------------------------------------------
# msm_sorted
# ---------------------------------------------------------------------------

def _dup_rows(n, bsz, seed):
    """Random scalars with 0, 1 and p - 1 up front and a run of duplicates
    (long runs of equal digits across block boundaries)."""
    rng = _rng(seed)
    rows = []
    for _ in range(bsz):
        row = [rng.randrange(P) for _ in range(n)]
        row[0], row[1], row[2] = 0, 1, P - 1
        for j in range(10, min(n, 30)):
            row[j] = row[10]
        rows.append(row)
    return rows


@pytest.mark.parametrize("c_bits,row_chunk", [(8, 5), (8, 0), (None, 0)])
def test_msm_sorted_equals_msm_multi_and_host(c_bits, row_chunk, monkeypatch):
    """row_chunk > 0: a memory budget of row_chunk rows per rows call, so
    the 64 rows go in several calls; c_bits None: the window of the width
    (window_bits)."""
    host, pts = _g1_points(48, 1, identity_at=47)
    rows = _dup_rows(48, 2, 2)
    scal = torch.from_numpy(_limbs(rows))
    if row_chunk:
        monkeypatch.setattr(MS, "ROWS_CALL_BYTES",
                            row_chunk * (3 * MS.POINT_BYTES["fq"] * 48 // 4 + 16 * 48))
        assert MS._rows_per_call(CT.FQ_OPS, 48, 4) == row_chunk
    got = MS.msm_sorted(CT.FQ_OPS, pts, scal, c_bits=c_bits, k_block=4, cutoff=4)
    want = _host_sums(host, rows, G1.identity())
    assert _to_host(CT.FQ_OPS, got) == want
    if not row_chunk:
        assert _to_host(CT.FQ_OPS, TM.msm_multi(CT.FQ_OPS, pts, scal)) == want


def c13_case():
    """12 points (one the identity) and one row of scalars: host points,
    port points, scalar rows and their limbs."""
    host, pts = _g1_points(12, 3, identity_at=5)
    rows = _dup_rows(12, 1, 4)
    return host, pts, rows, _limbs(rows)


def test_msm_sorted_c13_equals_jax_and_host():
    """c = 13, the route's window at 2^16 points and up, against the JAX
    msm_sorted on the same numpy inputs (as host points) and against host
    sums."""
    host, pts, rows, limbs = c13_case()
    got = MS.msm_sorted(CT.FQ_OPS, pts, torch.from_numpy(limbs), c_bits=13, k_block=4,
                        cutoff=4)
    ref = [G1.identity() if v is None else G1(*v)
           for v in JR.read("msm_sorted_c13")[1]["points"]]
    ours = _to_host(CT.FQ_OPS, got)
    assert ours == ref
    assert ours == _host_sums(host, rows, G1.identity())


@pytest.mark.parametrize("widths", [
    [1 << 16], [1 << 21], [2_122_382], [3_300_638], [1 << 22], range(1, (1 << 16) + 1),
], ids=["2^16", "2^21", "full1024_signals", "full4kb_signals", "2^22", "1..2^16"])
def test_window_bits(widths):
    """13 at 2^16 points and at every width the benchmark's MSMs run (the h
    MSM's 2^21 and 2^22 points, the signal MSMs' 2,122,382 and 3,300,638);
    from 1 to 2^16 between the smallest window msm_sorted accepts and 13,
    never narrower as n grows."""
    prev = MS.C_BITS_MIN
    for n in widths:
        c = MS.window_bits(n)
        assert MS.C_BITS_MIN <= c <= 13 and c >= prev, (n, c)
        if n >= 1 << 16:
            assert c == 13, n
        prev = c
    _, pts = _g1_points(2, 1)
    with pytest.raises(ValueError, match="at least"):
        MS.msm_sorted(CT.FQ_OPS, pts, torch.zeros((F.LIMBS, 1, 2), dtype=torch.int32),
                      c_bits=MS.C_BITS_MIN - 1)


def test_msm_sorted_column_slices_short_last():
    """Column slices 16 + 16 + 8: the sum over disjoint column subsets is the
    same group element; a slice wider than n is no slicing."""
    host, pts = _g1_points(40, 5)
    rows = _dup_rows(40, 2, 6)
    rows[1][20:] = [0] * 20  # batch element 1 has no digit in the last slices
    scal = torch.from_numpy(_limbs(rows))
    want = _host_sums(host, rows, G1.identity())
    for col_chunk in (16, 64):
        got = MS.msm_sorted(CT.FQ_OPS, pts, scal, c_bits=8, k_block=4, cutoff=4,
                            col_chunk=col_chunk)
        assert _to_host(CT.FQ_OPS, got) == want, col_chunk


def test_msm_sorted_zero_vector():
    _, pts = _g1_points(8, 7)
    scal = torch.zeros((F.LIMBS, 2, 8), dtype=torch.int32)
    got = MS.msm_sorted(CT.FQ_OPS, pts, scal, k_block=4, cutoff=4)
    assert _to_host(CT.FQ_OPS, got) == [G1.identity()] * 2


def test_msm_sorted_g2():
    host, pts = _g2_points(10, 8)
    rows = _dup_rows(10, 1, 9)
    scal = torch.from_numpy(_limbs(rows))
    got = MS.msm_sorted(CT.FQ2_OPS, pts, scal, c_bits=8, k_block=4, cutoff=4)
    assert _to_host(CT.FQ2_OPS, got) == _host_sums(host, rows, G2.identity())


def test_msm_sorted_rejects_bad_shapes():
    _, pts = _g1_points(8, 10)
    with pytest.raises(ValueError, match="point count"):
        MS.msm_sorted(CT.FQ_OPS, pts, torch.zeros((F.LIMBS, 1, 9), dtype=torch.int32))
    with pytest.raises(ValueError, match="expects scalars"):
        MS.msm_sorted(CT.FQ_OPS, pts, torch.zeros((F.LIMBS, 8), dtype=torch.int32))


# ---------------------------------------------------------------------------
# signal plan and the window-pruned MSM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c_bits", [8, 13])
def test_signal_plan_equals_jax(c_bits):
    limbs = _limbs(_witness_like(64, 11))
    perm, prefixes = MS.build_signal_plan(torch.from_numpy(limbs), c_bits)
    jperm, jprefixes = JS.build_signal_plan(jnp.asarray(limbs), c_bits=c_bits)
    assert perm.numpy().tolist() == np.asarray(jperm).tolist()
    assert prefixes == tuple(jprefixes)
    assert prefixes[0] <= 64 and prefixes[-1] < prefixes[0]


def pruned_case():
    """24 G1 points and two witness-like rows under their c = 8 plan: host
    points, points, rows, limbs, scalars, plan and the permuted points."""
    host, pts = _g1_points(24, 12)
    rows = _witness_like(24, 13)
    limbs = _limbs(rows)
    scal = torch.from_numpy(limbs)
    perm, prefixes = MS.build_signal_plan(scal, 8)
    return host, pts, rows, limbs, scal, perm, prefixes, _permuted(pts, perm)


def test_msm_sorted_pruned_equals_dense_and_jax():
    """Pruned over the permuted points == msm_sorted over the originals ==
    host sums == the JAX msm_sorted_pruned (as host points, frozen by
    tests/make_jax_reference.py)."""
    host, pts, rows, limbs, scal, perm, prefixes, pts_p = pruned_case()
    want = _host_sums(host, rows, G1.identity())
    dense = MS.msm_sorted(CT.FQ_OPS, pts, scal, c_bits=8, k_block=4, cutoff=4)
    assert _to_host(CT.FQ_OPS, dense) == want
    got = MS.msm_sorted_pruned(CT.FQ_OPS, pts_p, scal, perm, prefixes, c_bits=8,
                               k_block=4, cutoff=4)
    assert _to_host(CT.FQ_OPS, got) == want
    ref = [G1.identity() if v is None else G1(*v)
           for v in JR.read("msm_sorted_pruned_c8")[1]["points"]]
    assert ref == want


def test_msm_sorted_pruned_g2():
    host, pts = _g2_points(9, 14)
    rng = _rng(15)
    rows = [[rng.randrange(256) if j % 3 else rng.randrange(P) for j in range(9)]]
    scal = torch.from_numpy(_limbs(rows))
    perm, prefixes = MS.build_signal_plan(scal, 8)
    got = MS.msm_sorted_pruned(CT.FQ2_OPS, _permuted(pts, perm), scal, perm, prefixes,
                               c_bits=8, k_block=4, cutoff=4)
    assert _to_host(CT.FQ2_OPS, got) == _host_sums(host, rows, G2.identity())


def test_stale_plan_returns_none():
    """A batch whose digits reach past the plan's prefixes is refused by
    both pruned MSMs, never mis-proved."""
    _, pts = _g1_points(16, 16)
    rng = _rng(17)
    small = torch.from_numpy(_limbs([[rng.randrange(256) for _ in range(16)]]))
    big = torch.from_numpy(_limbs([[rng.randrange(P) for _ in range(16)]]))
    perm, prefixes = MS.build_signal_plan(small, 13)
    pts_p = _permuted(pts, perm)
    assert MS.msm_sorted_pruned(CT.FQ_OPS, pts_p, big, perm, prefixes, c_bits=13) is None
    assert MS.msm_bitserial(CT.FQ_OPS, pts_p, big, perm, prefixes, c_bits=13) is None
    with pytest.raises(ValueError, match="windows"):
        MS.msm_sorted_pruned(CT.FQ_OPS, pts_p, small, perm, prefixes, c_bits=8)


def test_width_groups():
    groups = MS._width_groups([100, 0, 95, 10, 87, 88, 10, 1])
    assert groups == [(100, [0, 2, 5]), (87, [4]), (10, [3, 6]), (1, [7])]


# ---------------------------------------------------------------------------
# bit-serial MSM
# ---------------------------------------------------------------------------

def test_msm_bitserial_g1_with_and_without_plan():
    """Planless and under a plan, k_block 4: neither n = 22 nor some of the
    plan's prefixes are a multiple of k_block, and each is padded, not
    refused."""
    host, pts = _g1_points(22, 18)
    rows = _witness_like(22, 19)
    scal = torch.from_numpy(_limbs(rows))
    want = _host_sums(host, rows, G1.identity())
    got = MS.msm_bitserial(CT.FQ_OPS, pts, scal, c_bits=8, k_block=4)
    assert _to_host(CT.FQ_OPS, got) == want
    perm, prefixes = MS.build_signal_plan(scal, 8)
    assert any(p % 4 for p in prefixes)
    got = MS.msm_bitserial(CT.FQ_OPS, _permuted(pts, perm), scal, perm, prefixes,
                           c_bits=8, k_block=4)
    assert _to_host(CT.FQ_OPS, got) == want


def test_msm_bitserial_equals_jax():
    """c = 13 under a plan, against the JAX msm_bitserial (whose column
    width must be a multiple of k_block: 16 here)."""
    host, pts = _g1_points(16, 20)
    rows = _witness_like(16, 21)
    limbs = _limbs(rows)
    scal = torch.from_numpy(limbs)
    perm, prefixes = MS.build_signal_plan(scal, 13)
    pts_p = _permuted(pts, perm)
    got = MS.msm_bitserial(CT.FQ_OPS, pts_p, scal, perm, prefixes, c_bits=13, k_block=4)
    ref = JS.msm_bitserial(CJ.FQ_OPS, _jax_points(pts_p), jnp.asarray(limbs),
                           perm.numpy().astype(np.int32), prefixes, c_bits=13, k_block=4)
    ours = _to_host(CT.FQ_OPS, got)
    assert ours == _jax_to_host(CJ.FQ_OPS, ref)
    assert ours == _host_sums(host, rows, G1.identity())


def test_msm_bitserial_g2_with_and_without_plan():
    host, pts = _g2_points(7, 22)
    rng = _rng(23)
    rows = [[rng.randrange(256) if j % 3 else rng.randrange(P) for j in range(7)]]
    scal = torch.from_numpy(_limbs(rows))
    want = _host_sums(host, rows, G2.identity())
    assert _to_host(CT.FQ2_OPS, MS.msm_bitserial(CT.FQ2_OPS, pts, scal, c_bits=8,
                                                 k_block=4)) == want
    perm, prefixes = MS.build_signal_plan(scal, 8)
    got = MS.msm_bitserial(CT.FQ2_OPS, _permuted(pts, perm), scal, perm, prefixes,
                           c_bits=8, k_block=4)
    assert _to_host(CT.FQ2_OPS, got) == want
