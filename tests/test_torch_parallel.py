"""The port's multi-GPU prove against the JAX package, on the CPU over gloo:

  * mesh_shape equals the shape of the JAX make_mesh for 1..8 devices (the
    conftest's eight virtual CPU devices), every dp included;
  * shard_ntt_tables and shard_local_scalars equal the JAX functions';
  * one 4-rank spawn (parallel/launch.py, the rank body
    scripts/mesh_checks.py::check_job) builds the meshes (2, 2), (1, 4)
    and (4, 1) from one world and runs on the two with msm > 1:
    sharded_h_eval at log_m = 9, B = 2, whose blocks must equal the JAX
    package's unsharded NTT.shifted_ntt(NTT.ntt(x, inverse=True)), and
    sharded_sort_msm at c = 8, K = 4 over 13 points (padded with
    identities), equal to msm_sorted; and on all three prove_batch(mesh=)
    on the toy of tests/test_torch_prover.py at B = 4 with a carried JAX
    key, whose proofs on every rank must equal the JAX prove_batch's under
    random.Random(42), and verify; and a batch of dp + 1, refused;
  * spawn raises a rank's exception with its traceback, keeps its
    deadline and leaves no child behind; make_mesh refuses to run without
    a process group, over another backend than asked, or short of the
    group's ranks; resolve_device names the current card.

The JAX key, witness, proofs and h_ref are the JAX package's outputs for
fixed seeds, frozen by tests/make_jax_reference.py; the ranks prove while
the parent runs the msm_sorted they are held to. Exact equality
everywhere."""

import concurrent.futures
import multiprocessing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_jax_reference as JR
from test_torch_prover import _port_cc, _proof_key, build_toy, carry_arrays
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.core import field as JF
from zkemail_tpu.core import limbs as JLB
from zkemail_tpu.parallel import sharding as JS
from zkemail_tpu.prover import groth16 as JG
from zkemail_tpu_torch import device as D
from zkemail_tpu_torch.core import curve_torch as CT
from zkemail_tpu_torch.ops import msm_sort as MS
from zkemail_tpu_torch.ops.msm import fixed_base_batch
from zkemail_tpu_torch.parallel import sharding as TS
from zkemail_tpu_torch.parallel.launch import spawn
from zkemail_tpu_torch.prover.containers import verify
from zkemail_tpu_torch.scripts.mesh_checks import affine_ints, check_job

torch.set_num_threads(1)

L = JF.LIMBS
MESHES = [2, 1, 4]  # dp of the (2, 2), (1, 4) and (4, 1) meshes of 4 ranks
SHAPES = [(2, 2), (1, 4), (4, 1)]
SHARDED = [i for i, (_, msm) in enumerate(SHAPES) if msm > 1]
LOG_M, H_BATCH = 9, 2
MSM_N, C_BITS, K_BLOCK = 13, 8, 4
BATCH = [3, 11, 5, 7]  # the toy's x values: B = 4


def _fr_mont(rng, shape):
    """Random Fr values in Montgomery form as (L, *shape) limbs."""
    vals = [int.from_bytes(rng.bytes(32), "little") % JF.R for _ in range(int(np.prod(shape)))]
    return JLB.ints_to_limbs(np.array([JF.FR.to_mont(v) for v in vals], dtype=object)
                             ).reshape((L,) + shape)


def h_eval_values():
    """The sharded_h_eval input: (L, 2^LOG_M, H_BATCH) random Fr values."""
    return _fr_mont(np.random.default_rng(3), (1 << LOG_M, H_BATCH))


def _msm_case():
    """13 G1 points and B = 2 scalar rows: row 0 full 40-bit scalars, row 1
    mostly zero, so the rows' nonzero counts differ."""
    rng = np.random.default_rng(5)
    pts = fixed_base_batch("g1", torch.as_tensor(
        JLB.ints_to_limbs(np.arange(2, MSM_N + 2, dtype=object))))
    vals = [[int(v) for v in rng.integers(1, 1 << 40, MSM_N)],
            [int(v) if i % 4 == 1 else 0 for i, v in enumerate(rng.integers(1, 1 << 40, MSM_N))]]
    sc = JLB.ints_to_limbs(np.array(vals, dtype=object))
    return {k: v.numpy() for k, v in pts.items()}, sc


@pytest.fixture(scope="module")
def world():
    """The 4-rank run and its JAX references (see the module docstring): the
    JAX key (seed 42), its witness for BATCH, its proofs under
    random.Random(42) and h_ref, JAX's shifted_ntt(ntt(x, inverse=True))."""
    cc = build_toy()
    pk = JR.load_key("toy_key_seed42")
    arrays, meta = JR.read("toy_prove_seed42")
    assert meta["xs"] == BATCH
    w = arrays["w"]
    x = h_eval_values()
    pts, sc = _msm_case()
    job = {
        "device": "cpu", "backend": "gloo", "meshes": MESHES, "divisible": True,
        "h_eval": {"log_m": LOG_M, "values": x},
        "sort_msm": {"g2": False, "points": pts, "scalars": sc, "c_bits": C_BITS,
                     "k_block": K_BLOCK},
        "prove": {"key": {"arrays": carry_arrays(pk)}, "circuit": _port_cc(cc), "witness": w,
                  "seed": 42},
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, check_job, 4, "gloo", (job,), 300.0)
        proofs = JR.proofs_from(meta["proofs"])
        h_ref = arrays["h_ref"]
        pts_t = {k: torch.as_tensor(v) for k, v in pts.items()}
        msm_ref = affine_ints(CT.FQ_OPS, MS.msm_sorted(
            CT.FQ_OPS, pts_t, torch.as_tensor(sc), c_bits=C_BITS, k_block=K_BLOCK))
        ranks = ranks.result()
    per_mesh = [[r[i] for r in ranks] for i in range(len(MESHES))]
    return {"ranks": per_mesh, "proofs": proofs, "h_ref": h_ref, "msm_ref": msm_ref,
            "vk": pk.vk}


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_equals_jax(n):
    for dp in [None] + list(range(1, n + 1)):
        ref = JS.make_mesh(n, dp=dp).shape
        assert TS.mesh_shape(n, dp) == (ref["dp"], ref["msm"])


@pytest.mark.parametrize("log_m,shards", [(6, 2), (6, 4), (9, 8)])
def test_shard_ntt_tables_equal_jax(log_m, shards):
    ours, ref = TS.shard_ntt_tables(log_m, shards), JS.shard_ntt_tables(log_m, shards)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k


@pytest.mark.parametrize("idx", range(4))
def test_shard_local_scalars_equals_jax(idx):
    scal = np.random.default_rng(7).integers(0, 4096, (L, 3, 10)).astype(np.int32)
    n_pad, n_msm = 12, 4
    ref = np.asarray(JG._shard_local_scalars(jnp.asarray(scal), n_pad, n_msm, idx))
    got = TS.shard_local_scalars(torch.as_tensor(scal), n_pad, n_msm, idx).numpy()
    assert np.array_equal(got, ref)


def test_shard_local_points_pad_with_identity():
    pts = {k: torch.as_tensor(v) for k, v in _msm_case()[0].items()}
    part = TS.shard_local_points(CT.FQ_OPS, pts, 16, 4, 3)  # columns 12, then 3 pads
    ident = CT.ec_identity(CT.FQ_OPS, (3,), "cpu")
    assert torch.equal(part["x"][:, 0], pts["x"][:, 12])
    assert all(torch.equal(part[k][:, 1:], ident[k]) for k in "xyz")


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_mesh_shapes_and_coords(world, i):
    per = world["ranks"][i]
    assert [r["shape"] for r in per] == [SHAPES[i]] * 4
    dp, msm = SHAPES[i]
    assert [r["coords"] for r in per] == [(r // msm, r % msm) for r in range(4)]


@pytest.mark.parametrize("i", SHARDED)
def test_sharded_h_eval_equals_jax(world, i):
    per = world["ranks"][i]
    for d in range(SHAPES[i][0]):
        blocks = [r["h_eval"] for r in per if r["coords"][0] == d]
        assert np.array_equal(np.concatenate(blocks, axis=1), world["h_ref"])


@pytest.mark.parametrize("i", SHARDED)
def test_sharded_sort_msm_equals_msm_sorted(world, i):
    assert all(r["sort_msm"] == world["msm_ref"] for r in world["ranks"][i])


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_sharded_prove_gives_the_jax_proofs(world, i):
    want = [_proof_key(p) for p, _ in world["proofs"]]
    pubs = [pub for _, pub in world["proofs"]]
    for r in world["ranks"][i]:
        got = r["prove"]["proofs"]
        assert [_proof_key(p) for p, _ in got] == want
        assert [pub for _, pub in got] == pubs
        assert "gather_s" in r["prove"]["timers"] and "plan" not in r["prove"]["timers"]


def test_sharded_proofs_verify(world):
    """Every mesh's proofs equal these (above); each verifies, and a
    tampered public is refused."""
    proofs = world["ranks"][0][0]["prove"]["proofs"]
    for proof, publics in proofs:
        assert verify(world["vk"], proof, publics)
    proof, publics = proofs[0]
    assert not verify(world["vk"], proof, [(publics[0] + 1) % JF.R])


def test_batch_not_divisible_by_dp_raises(world):
    for i, (dp, _) in enumerate(SHAPES):
        msgs = [r.get("divisible") for r in world["ranks"][i]]
        if dp > 1:
            assert all(m and "divisible" in m for m in msgs)


def test_spawn_raises_a_rank_error_and_keeps_its_deadline():
    with pytest.raises(RuntimeError, match="of 2 failed(.|\n)*no mesh of 2 devices with dp=3"):
        spawn(check_job, 2, "gloo", ({"device": "cpu", "backend": "gloo", "meshes": [3]},),
              timeout_s=120.0)
    with pytest.raises(TimeoutError):
        spawn(check_job, 2, "gloo", ({"device": "cpu", "backend": "gloo", "meshes": []},),
              timeout_s=0.5)
    assert not multiprocessing.active_children()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        TS.make_mesh(1, device_type="cpu")


@pytest.mark.parametrize("world,job,match", [
    (2, {"backend": "nccl", "meshes": [1]}, "expects backend nccl"),
    (3, {"backend": "gloo", "meshes": [2]}, r"\(2, 1\) mesh must cover"),
])
def test_make_mesh_refuses_a_wrong_backend_or_size(world, job, match):
    with pytest.raises(RuntimeError, match=match):
        spawn(check_job, world, "gloo", (dict(job, device="cpu"),), timeout_s=120.0)


def test_resolve_device_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert D.resolve_device() == torch.device("cuda", 3)
    assert D.resolve_device("cuda") == torch.device("cuda", 3)
    assert D.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert D.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve_device("cuda:0")
