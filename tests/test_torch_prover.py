"""The port's Groth16 slice against the JAX package on the CPU, on the toy
circuit of tests/test_groth16_e2e.py:

  * the port's groth16_setup equals the JAX one for the same seed, point for
    point;
  * a JAX proving key carried across by proving_key_from_arrays gives the
    JAX prover's proofs exactly (prove_batch at B = 2 under the same seeded
    random.Random), and the five pre-blinding MSM points agree;
  * the proofs verify, and a tampered public input fails;
  * prove_batch's sort route hits a fresh signal plan; a stale plan is
    missed, proved dense and rebuilt, from the unzeroed witness, and b2's
    dense fallback proves through;
  * the bucket reference (scripts/msm_routes.py::bucket_points) gives the
    same points and proofs.

The JAX package's key, witness, proofs and points are its outputs for
fixed seeds, frozen by tests/make_jax_reference.py and read from
tests/fixtures/jax_reference/."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import make_jax_reference as JR
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.circuits.builder import ConstraintSystem
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.ops import msm as TM
from zkemail_tpu_torch.ops import msm_sort as MS
from zkemail_tpu_torch.prover import groth16 as TG
from zkemail_tpu_torch.prover.containers import verify
from zkemail_tpu_torch.prover.convert import proving_key_from_arrays, r1cs_from_arrays
from zkemail_tpu_torch.prover.setup import groth16_setup
from zkemail_tpu_torch.scripts import msm_routes as MR

torch.set_num_threads(1)

QUERIES = ("a_query", "b1_query", "b2_query", "c_query", "h_query")
XS = [3, 11]


def build_toy():
    """x (private), y (public): x^3 + x + 5 == y (as tests/test_groth16_e2e.py)."""
    cs = ConstraintSystem("toy")
    x = cs.add_input("x", ())
    x2 = cs.mul(x, x)
    x3 = cs.mul(x2, x)
    y = cs.define(x3 + x + 5)
    cs.mark_public(y)
    return cs.compile()


def _capture(mod, name, mp, store):
    orig = getattr(mod, name)

    def wrapped(*args, **kwargs):
        store[name] = orig(*args, **kwargs)
        return store[name]

    mp.setattr(mod, name, wrapped)


def _g1(p):
    return (p.inf, p.x, p.y) if not p.inf else (True,)


def _g2(p):
    return (p.inf, p.x.c0, p.x.c1, p.y.c0, p.y.c1) if not p.inf else (True,)


def _proof_key(proof):
    return (_g1(proof.a), _g2(proof.b), _g1(proof.c))


def _port_cc(cc):
    return r1cs_from_arrays(name=cc.name, A=cc.A, B=cc.B, C=cc.C,
                            n_constraints=cc.n_constraints,
                            n_signals=cc.n_signals, n_public=cc.n_public)


def carry_arrays(pk) -> dict:
    """A JAX ProvingKey as proving_key_from_arrays' arguments: numpy arrays
    and ints only."""
    def g1(p):
        return None if p.inf else (p.x, p.y)

    def g2(p):
        return None if p.inf else ((p.x.c0, p.x.c1), (p.y.c0, p.y.c1))

    queries = {
        q: {k: tuple(np.asarray(c) for c in v) if isinstance(v, tuple) else np.asarray(v)
            for k, v in getattr(pk, q).items()}
        for q in QUERIES
    }
    points = {"alpha_g1": g1(pk.alpha_g1), "beta_g1": g1(pk.beta_g1),
              "delta_g1": g1(pk.delta_g1), "beta_g2": g2(pk.beta_g2),
              "delta_g2": g2(pk.delta_g2), "gamma_g2": g2(pk.vk.gamma_g2)}
    return dict(domain_log2=pk.domain_log2, n_public=pk.n_public,
                n_constraints=pk.n_constraints, queries=queries, points=points,
                ic=[g1(p) for p in pk.vk.ic])


def _carry_pk(pk):
    """A JAX ProvingKey -> the port's, through numpy arrays and ints only."""
    return proving_key_from_arrays(**carry_arrays(pk), device="cpu")


@pytest.fixture(scope="module")
def toy():
    """The toy and the JAX package's outputs on it: its key (seed 42), its
    witness for XS, and its prove_batch's proofs under random.Random(7) and
    five pre-blinding points."""
    cc = build_toy()
    pk = JR.load_key("toy_key_seed42")
    arrays, meta = JR.read("toy_prove_seed7")
    assert meta["xs"] == XS
    return SimpleNamespace(cc=cc, pk=pk, w=arrays["w"], proofs=JR.proofs_from(meta["proofs"]),
                           points=JR.points_from(meta["points"]))


@pytest.fixture(scope="module")
def carried(toy):
    pk = _carry_pk(toy.pk)
    cc = _port_cc(toy.cc)
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        _capture(TG, "prove_points", mp, store)
        timers = {}
        proofs = TG.prove_batch(pk, cc, toy.w, rng=random.Random(7), timers=timers,
                                device="cpu")
    return SimpleNamespace(cc=cc, pk=pk, proofs=proofs, points=store["prove_points"],
                           timers=timers)


def test_setup_equals_jax(toy):
    pk = groth16_setup(_port_cc(toy.cc), seed=42, device="cpu")
    ref = toy.pk
    assert (pk.domain_log2, pk.n_public, pk.n_constraints) == (
        ref.domain_log2, ref.n_public, ref.n_constraints)
    for q in QUERIES:
        ours, theirs = getattr(pk, q), getattr(ref, q)
        for k in ("x", "y", "z"):
            pairs = zip(ours[k], theirs[k]) if q == "b2_query" else [(ours[k], theirs[k])]
            for a, b in pairs:
                assert (a.numpy() == np.asarray(b)).all(), (q, k)
    for name in ("alpha_g1", "beta_g1", "delta_g1"):
        assert _g1(getattr(pk, name)) == _g1(getattr(ref, name))
    for name in ("beta_g2", "delta_g2"):
        assert _g2(getattr(pk, name)) == _g2(getattr(ref, name))
    assert _g2(pk.vk.gamma_g2) == _g2(ref.vk.gamma_g2)
    assert [_g1(p) for p in pk.vk.ic] == [_g1(p) for p in ref.vk.ic]


def test_carried_key_gives_the_jax_proofs(toy, carried):
    assert [pub for _, pub in carried.proofs] == [pub for _, pub in toy.proofs]
    assert [_proof_key(p) for p, _ in carried.proofs] == [_proof_key(p) for p, _ in toy.proofs]
    # the five pre-blinding points (a, b2, b1, c, h), per batch element
    for ours, theirs, conv in zip(carried.points, toy.points, (_g1, _g2, _g1, _g1, _g1)):
        assert [conv(p) for p in ours] == [conv(p) for p in theirs]


def test_carried_proofs_verify_and_tampered_fails(carried):
    for x, (proof, publics) in zip(XS, carried.proofs):
        assert publics == [x**3 + x + 5]
        assert verify(carried.pk.vk, proof, publics)
    proof, publics = carried.proofs[0]
    assert not verify(carried.pk.vk, proof, [publics[0] + 1])


# ---------------------------------------------------------------------------
# the sort route (ops/msm_sort.py) and its signal plan
# ---------------------------------------------------------------------------

def _host_point(ops, pt):
    """The first point of a port point batch as a comparable host tuple."""
    aff = CT.ec_to_affine(ops, pt)
    if bool(aff["inf"][0]):
        return (True,)
    fq = CT.FQ_OPS
    if ops is CT.FQ_OPS:
        return (False, int(fq.to_ints(aff["x"])[0]), int(fq.to_ints(aff["y"])[0]))
    return (False,) + tuple(int(fq.to_ints(c)[0]) for c in (*aff["x"], *aff["y"]))


def _witness_t(toy):
    return torch.tensor(toy.w).movedim(2, 1)  # (L, B, n_signals)


def _stale_plan(pk, toy):
    """A plan built from an all-zero batch: every prefix is 0, so any
    nonzero digit misses it."""
    pk.cache.pop("signal_plan", None)
    TG._signal_plan(pk, torch.zeros_like(_witness_t(toy)))


def test_sort_route_gives_the_jax_proofs(toy, carried):
    """prove_batch's sort route (pruned MSMs under a plan built from this
    batch: every signal MSM hits it) gives the JAX prover's proofs under
    the same rng."""
    assert carried.timers["plan"] == {"a": "hit", "b2": "hit", "b1": "hit", "c": "hit"}
    assert [_proof_key(p) for p, _ in carried.proofs] == [_proof_key(p) for p, _ in toy.proofs]


def test_stale_plan_proves_dense_and_rebuilds(toy):
    """A stale plan, one proof: the a MSM misses, proves dense and rebuilds
    the plan; the other three hit the new plan; the proof is the JAX
    prover's first (the rng draws r, s per proof)."""
    pk, cc = _carry_pk(toy.pk), _port_cc(toy.cc)
    _stale_plan(pk, toy)
    timers = {}
    proofs = TG.prove_batch(pk, cc, toy.w[:, :, :1], rng=random.Random(7), timers=timers,
                            device="cpu")
    assert timers["plan"] == {"a": "miss", "b2": "hit", "b1": "hit", "c": "hit"}
    assert _proof_key(proofs[0][0]) == _proof_key(toy.proofs[0][0])


def test_g2_dense_fallback_proves_through(toy):
    """On a miss the b2 MSM proves through the dense Fq2 msm_sorted (the JAX
    package's G2 fallback never compiled on its TPU) and gives the JAX b2
    points."""
    pk = _carry_pk(toy.pk)
    _stale_plan(pk, toy)
    w_t = _witness_t(toy)
    out, outcome = TG._msm_signal_call(pk, "b2", w_t, w_t)
    assert outcome == "miss"
    for i in range(w_t.shape[1]):
        b2 = TM.map_coords(out, lambda c: c[:, i : i + 1])
        assert _host_point(CT.FQ2_OPS, b2) == _g2(toy.points[1][i])


def test_plan_rebuilt_from_unzeroed_witness(toy):
    """After a miss on the c MSM the plan is rebuilt from the witness, not
    from the c scalars with their public columns zeroed (the JAX package's
    rebuild, under which the next a MSM misses again)."""
    pk = _carry_pk(toy.pk)
    _stale_plan(pk, toy)
    w_t = _witness_t(toy)
    c_scal = w_t.clone()
    c_scal[:, :, : pk.n_public + 1] = 0
    out, outcome = TG._msm_signal_call(pk, "c", c_scal, w_t)
    assert outcome == "miss"
    assert _host_point(CT.FQ_OPS, out) == _g1(toy.points[3][0])
    perm, prefixes, _ = pk.cache["signal_plan"]
    want_perm, want_prefixes = MS.build_signal_plan(w_t)
    assert prefixes == want_prefixes and torch.equal(perm, want_perm)
    assert prefixes != MS.build_signal_plan(c_scal)[1]
    assert TG._msm_signal_call(pk, "a", w_t, w_t)[1] == "hit"


def test_bucket_reference_gives_the_jax_proofs(toy, carried):
    """The bucket route (every MSM through msm_multi), blinded under the same
    rng, gives the sort route's pre-blinding points and the JAX proofs."""
    w = torch.tensor(toy.w)
    points = MR.bucket_points(carried.pk, carried.cc, w)
    for ours, theirs, conv in zip(points, carried.points, (_g1, _g2, _g1, _g1, _g1)):
        assert [conv(p) for p in ours] == [conv(p) for p in theirs]
    proofs = TG.blind(carried.pk, points, w, random.Random(7))
    assert [_proof_key(p) for p, _ in proofs] == [_proof_key(p) for p, _ in toy.proofs]
