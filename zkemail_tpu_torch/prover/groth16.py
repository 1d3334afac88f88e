"""Groth16 prover on the card: witness batch -> proofs.

The port of ``zkemail_tpu/prover/groth16.py`` (``prove_batch`` and
``prove``):

  1. the h stage: sparse QAP matvecs A·w and B·w (gather, K1 Montgomery
     product, int32 ``index_add_``, lazy reduction) with the instance rows
     appended; C·w = A·w ∘ B·w rowwise; h evaluations on the shifted domain
     sigma*D — snarkjs' CircomReduction basis (iNTT -> sigma shift -> NTT ->
     a*b - c);
  2. five MSMs over the CRS queries: h, a, b1 and c on G1 (K2), b2 on G2
     (K3), by the JAX package's route on an accelerator: the sort/telescope
     MSM (``ops/msm_sort.py``) for h, and for the four signal MSMs its
     window-pruned form under a signal plan cached on the key; the c MSM
     runs over the whole signal vector with its public columns zeroed
     against an identity-padded query. The bucket ``ops/msm.py::msm_multi``
     (the JAX package's CPU route) is the reference it is held to
     (``scripts/msm_routes.py``);
  3. batched affine conversion, then the r/s blinding on the host, in the
     JAX package's order, so a seeded ``random.Random`` gives the same
     proofs as the JAX prover.

With a (dp, msm) mesh (``parallel/sharding.py``) ``prove_batch`` runs the
JAX package's sharded path (``_prove_sharded``, ``_shard_crs``,
``_h_stage_mesh_fn``, ``_msm_stage_sharded_fn``) on every rank of the
mesh: the batch splits over "dp", the five MSMs (dense, no signal plan)
and the h stage's NTTs over "msm", and the proofs equal the unsharded
ones for every mesh shape.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ..core import curve_torch as CT
from ..core import field as F
from ..core import limbs as LB
from ..core.curve import G1, G2
from ..core.towers import Fq2
from ..device import resolve_device
from ..ops import ntt as NTT
from ..ops import msm_sort as MS
from ..ops.msm import _first, concat_points, map_coords
from ..parallel.sharding import (
    axis_size, check_ntt_shards, combine_window_sums, dp_sharded_inputs, gather_points,
    mesh_ntt_consts, shard_local_points, shard_window_sums, sharded_h_eval,
)
from .containers import Proof
from .setup import ProvingKey, matrix_pack

P = F.R
FS = LB.FR_SPEC
L = F.LIMBS

# qap_matvec sums each row's products lazily in int32: k products stay below
# 2^31 per limb and below 2^264 in value (k * p < 2^264) for k <= 1024.
MAX_ROW_ENTRIES = 1024


def _lazy_reduce_to_mont(t: torch.Tensor) -> torch.Tensor:
    """(L, m, ...) int32 limb sums of Montgomery values (each limb below
    2^31, the value below 2^264) -> canonical Montgomery limbs."""
    outs = []
    carry = torch.zeros_like(t[0])
    for i in range(L):
        v = t[i] + carry
        outs.append(v & F.LIMB_MASK)
        carry = v >> F.LIMB_BITS
    x = torch.stack(outs, dim=0)
    # x < 2^264 and a sum of Montgomery values: mont_mul(x, R) = x mod p
    r1 = torch.tensor(FS.r_limbs, dtype=torch.int32, device=t.device)
    return LB.mont_mul(FS, x, r1.reshape((L,) + (1,) * (x.dim() - 1)))


def qap_matvec(mat, w_mont: torch.Tensor, m: int) -> torch.Tensor:
    """(M w) per-constraint dot products for one packed matrix (rows, cols,
    Montgomery coeff limbs), padded to the domain size m; Montgomery form.

    w_mont may carry trailing batch axes (L, n_signals, ...)."""
    rows, cols, coeffs = mat
    gathered = w_mont[:, cols]  # (L, nnz, ...)
    coeffs = coeffs.reshape(tuple(coeffs.shape) + (1,) * (w_mont.dim() - 2))
    prods = LB.mont_mul(FS, gathered, coeffs)
    acc = torch.zeros((L, m) + tuple(prods.shape[2:]), dtype=torch.int32,
                      device=prods.device)
    acc.index_add_(1, rows, prods)
    return _lazy_reduce_to_mont(acc)


def compute_h(mats, w_mont: torch.Tensor, log_m: int, plan=None, *,
              n_constraints: int, n_public: int) -> torch.Tensor:
    """h evaluations on the shifted domain sigma*D (Montgomery, length m).

    The CircomReduction witness map: evaluate A·w, B·w on D with the
    n_public+1 instance rows appended at n_constraints, interpolate,
    re-evaluate on sigma*D, and return a*b - c there. Division by the
    vanishing polynomial is not performed: Z is the constant -2 on sigma*D
    and the CRS h query absorbs it (setup.groth16_setup)."""
    m = 1 << log_m
    aw = qap_matvec(mats["A"], w_mont, m)
    bw = qap_matvec(mats["B"], w_mont, m)
    # instance rows: row n_constraints + s carries public signal s (A only)
    npub1 = n_public + 1
    aw[:, n_constraints : n_constraints + npub1] = w_mont[:, :npub1]
    cw = LB.mont_mul(FS, aw, bw)
    a_e = NTT.shifted_ntt(NTT.ntt(aw, inverse=True, plan=plan), plan=plan)
    b_e = NTT.shifted_ntt(NTT.ntt(bw, inverse=True, plan=plan), plan=plan)
    c_e = NTT.shifted_ntt(NTT.ntt(cw, inverse=True, plan=plan), plan=plan)
    return LB.sub(FS, LB.mont_mul(FS, a_e, b_e), c_e)


def _prove_consts(cc, pk: ProvingKey):
    """(mats, plan) on the key's device, cached on the key per circuit."""
    key = ("prove_consts", id(cc))
    if key not in pk.cache:
        mats = {}
        for which in ("A", "B"):
            rows = np.asarray(getattr(cc, which)[0], dtype=np.int64)
            if rows.size and np.bincount(rows).max() > MAX_ROW_ENTRIES:
                raise ValueError(
                    f"matrix {which} has a row with more than {MAX_ROW_ENTRIES} "
                    "entries; qap_matvec's int32 row sums would overflow"
                )
            mats[which] = matrix_pack(cc, which, pk.device)
        pk.cache[key] = (mats, NTT.domain_plan(pk.domain_log2, pk.device))
    return pk.cache[key]


def _h_stage(pk: ProvingKey, witness: torch.Tensor, mats, plan) -> torch.Tensor:
    """witness (L, n_signals, b) standard form -> h (L, b, m) standard form."""
    w_mont = LB.to_mont(FS, witness)
    h_evals = compute_h(
        mats, w_mont, pk.domain_log2, plan,
        n_constraints=pk.n_constraints, n_public=pk.n_public,
    )
    return LB.from_mont(FS, h_evals).movedim(2, 1)


def _results_to_host(a_dev, b2_dev, b1_dev, c_dev, h_dev, bsz: int):
    """(a, b2, b1, c, h) device point batches (B,) -> host point lists."""
    affs = (
        CT.ec_to_affine(CT.FQ_OPS, a_dev),
        CT.ec_to_affine(CT.FQ2_OPS, b2_dev),
        CT.ec_to_affine(CT.FQ_OPS, b1_dev),
        CT.ec_to_affine(CT.FQ_OPS, c_dev),
        CT.ec_to_affine(CT.FQ_OPS, h_dev),
    )
    fq = CT.FQ_OPS

    def g1_list(aff):
        xs, ys = fq.to_ints(aff["x"]), fq.to_ints(aff["y"])
        infs = aff["inf"].cpu().numpy()
        return [G1.identity() if infs[i] else G1(int(xs[i]), int(ys[i]))
                for i in range(bsz)]

    def g2_list(aff):
        x0, x1 = fq.to_ints(aff["x"][0]), fq.to_ints(aff["x"][1])
        y0, y1 = fq.to_ints(aff["y"][0]), fq.to_ints(aff["y"][1])
        infs = aff["inf"].cpu().numpy()
        return [
            G2.identity() if infs[i]
            else G2(Fq2(int(x0[i]), int(x1[i])), Fq2(int(y0[i]), int(y1[i])))
            for i in range(bsz)
        ]

    return (g1_list(affs[0]), g2_list(affs[1]), g1_list(affs[2]),
            g1_list(affs[3]), g1_list(affs[4]))


# the signal MSMs and the query of each
SIGNAL_MSMS = {"a": "a_query", "b2": "b2_query", "b1": "b1_query", "c": "c_query"}


def _signal_query(pk: ProvingKey, name: str) -> dict:
    """The unpermuted query of a signal MSM over all n_signals columns: the
    c query front-padded with n_public + 1 identities (cached on the key),
    so that the c MSM takes the full signal vector with its public columns
    zeroed, under the same plan as a, b1 and b2."""
    if name != "c":
        return getattr(pk, SIGNAL_MSMS[name])
    if "c_query_padded" not in pk.cache:
        ident = CT.ec_identity(CT.FQ_OPS, (pk.n_public + 1,), pk.device)
        pk.cache["c_query_padded"] = {
            k: torch.cat([ident[k], pk.c_query[k]], dim=1) for k in "xyz"
        }
    return pk.cache["c_query_padded"]


def _signal_plan(pk: ProvingKey, witness_t: torch.Tensor):
    """(perm, prefixes, permuted queries) of the key's signal plan, built on
    the device from the digits of witness_t (L, B, n_signals) when the key
    has none. The plan is a hint: every pruned MSM checks its batch against
    it and returns None on a miss (see _msm_signal_call)."""
    if "signal_plan" not in pk.cache:
        perm, prefixes = MS.build_signal_plan(witness_t)
        queries = {
            name: map_coords(_signal_query(pk, name), lambda c: c.index_select(1, perm))
            for name in SIGNAL_MSMS
        }
        pk.cache["signal_plan"] = (perm, prefixes, queries)
    return pk.cache["signal_plan"]


def _msm_signal_call(pk: ProvingKey, name: str, scalars: torch.Tensor,
                     witness_t: torch.Tensor):
    """One signal MSM (a, b2, b1 or c) on the sort route, window-pruned
    under the key's plan.

    scalars (L, B, n_signals) are this MSM's (the c MSM's have their public
    columns zeroed); witness_t is the batch's unzeroed witness, from which
    the plan is built. Returns (point batch (B,), "hit" | "miss"). On a
    miss the MSM runs dense through msm_sorted over the unpermuted query,
    b2's over Fq2 included, and the plan is rebuilt from witness_t: a plan
    built from the zeroed c scalars would put the public signals past its
    prefixes and miss again at the next a MSM."""
    ops = CT.FQ2_OPS if name == "b2" else CT.FQ_OPS
    perm, prefixes, queries = _signal_plan(pk, witness_t)
    out = MS.msm_sorted_pruned(ops, queries[name], scalars, perm, prefixes)
    if out is not None:
        return out, "hit"
    del pk.cache["signal_plan"], queries
    out = MS.msm_sorted(ops, _signal_query(pk, name), scalars)
    _signal_plan(pk, witness_t)
    return out, "miss"


def _marker(pk: ProvingKey, timers: dict | None):
    """mark(name): record the seconds since the previous mark (or since
    this call) as timers[name], after the device has finished; a no-op
    without timers."""
    sync = ((lambda: torch.cuda.synchronize(pk.device)) if pk.device.type == "cuda"
            else (lambda: None))
    t0 = [time.time()]

    def mark(name):
        if timers is not None:
            sync()
            now = time.time()
            timers[name] = round(now - t0[0], 3)
            t0[0] = now

    return mark


def msm_scalars(pk: ProvingKey, cc, witnesses: torch.Tensor):
    """witnesses (L, n_signals, B) standard form on the key's device -> the
    scalars of the five MSMs: h (L, B, m) from the h stage, and the
    witness as (L, B, n_signals)."""
    mats, plan = _prove_consts(cc, pk)
    # one proof at a time through the h stage bounds its NTT transients
    h_t = torch.cat(
        [_h_stage(pk, witnesses[:, :, i : i + 1], mats, plan)
         for i in range(witnesses.shape[2])],
        dim=1,
    )
    return h_t, witnesses.movedim(2, 1)


def prove_points(pk: ProvingKey, cc, witnesses: torch.Tensor, timers: dict | None = None):
    """The device part of proving: witnesses (L, n_signals, B) standard form
    on the key's device -> the five pre-blinding MSM results (a, b2, b1, c,
    h) as host point lists of length B, by the sort route. timers as in
    prove_batch."""
    mark = _marker(pk, timers)
    h_t, w_t = msm_scalars(pk, cc, witnesses)
    mark("h_stage_s")
    h_dev = MS.msm_sorted(CT.FQ_OPS, pk.h_query, h_t)
    mark("msm_h_s")
    del h_t
    c_scal = w_t.clone()
    c_scal[:, :, : pk.n_public + 1] = 0
    out, outcome = {}, {}
    for name in ("a", "b2", "b1", "c"):
        scal = c_scal if name == "c" else w_t
        out[name], outcome[name] = _msm_signal_call(pk, name, scal, w_t)
        mark(f"msm_{name}_s")
    if timers is not None:
        timers["plan"] = outcome
    return _results_to_host(out["a"], out["b2"], out["b1"], out["c"], h_dev,
                            witnesses.shape[2])


# ---------------------------------------------------------------------------
# the sharded prove on a (dp, msm) mesh (parallel/sharding.py)
# ---------------------------------------------------------------------------

def _mesh_key(mesh) -> tuple:
    return tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape)


def _shard_crs(mesh, pk: ProvingKey) -> dict:
    """This rank's "msm" slice of each of the five queries, with the padded
    query length: {query: (points, n_pad)}. Each query is padded to a
    multiple of the shard count with the identity, neutral under every
    route (the JAX package pads with all-zero coordinates, which the
    complete addition is not neutral to: the sort route never adds a
    zero-scalar lane into a weighted sum, so its results stand). The
    slices are copies, cached on the key for the last mesh it proved on."""
    key = _mesh_key(mesh)
    cached = pk.cache.get("shard_crs")
    if cached is not None and cached[0] == key:
        return cached[1]
    S = axis_size(mesh, "msm")
    idx = mesh.get_local_rank("msm")
    out = {}
    for name in ("a_query", "b1_query", "b2_query", "c_query", "h_query"):
        q = getattr(pk, name)
        ops = CT.FQ2_OPS if name == "b2_query" else CT.FQ_OPS
        n_pad = -(-_first(q).shape[1] // S) * S
        out[name] = (shard_local_points(ops, q, n_pad, S, idx), n_pad)
    pk.cache["shard_crs"] = (key, out)
    return out


def _mesh_ntt_consts(pk: ProvingKey, mesh) -> tuple:
    """mesh_ntt_consts of the key's domain on its device (this shard's
    four-step tables and the local NTT's plan), cached on the key for the
    last mesh."""
    key = _mesh_key(mesh)
    cached = pk.cache.get("mesh_ntt")
    if cached is None or cached[0] != key:
        cached = (key, mesh_ntt_consts(mesh, pk.domain_log2, pk.device))
        pk.cache["mesh_ntt"] = cached
    return cached[1]


def _h_stage_mesh(pk: ProvingKey, cc, w_loc: torch.Tensor, mesh,
                  timers: dict | None) -> torch.Tensor:
    """The h stage with its NTTs sharded over "msm": this rank's dp-local
    witnesses (L, n_signals, b) -> its block of the h evaluations
    (L, b, m / S), standard form, one proof at a time.

    Each rank computes the QAP matvecs over the whole domain (as the JAX
    package does) and keeps its block; a, b and c = a * b go through one
    four-step iNTT -> sigma shift -> NTT (sharded_h_eval) as three lanes,
    two gathers per proof."""
    mats, _ = _prove_consts(cc, pk)
    consts = _mesh_ntt_consts(pk, mesh)
    m = 1 << pk.domain_log2
    m2 = m // axis_size(mesh, "msm")
    lo = mesh.get_local_rank("msm") * m2
    nC, npub1 = pk.n_constraints, pk.n_public + 1
    out = []
    for i in range(w_loc.shape[2]):
        w_mont = LB.to_mont(FS, w_loc[:, :, i])
        aw = qap_matvec(mats["A"], w_mont, m)
        bw = qap_matvec(mats["B"], w_mont, m)
        aw[:, nC : nC + npub1] = w_mont[:, :npub1]
        ab = torch.stack([aw[:, lo : lo + m2], bw[:, lo : lo + m2]], dim=2)
        del aw, bw
        blk = torch.cat([ab, LB.mont_mul(FS, ab[..., :1], ab[..., 1:])], dim=2)
        e = sharded_h_eval(mesh, blk, pk.domain_log2, consts, timers)
        h = LB.sub(FS, LB.mont_mul(FS, e[..., 0], e[..., 1]), e[..., 2])
        out.append(LB.from_mont(FS, h))
    return torch.stack(out, dim=1)


def _msm_stage_sharded(pk: ProvingKey, mesh, w_t: torch.Tensor, h_t: torch.Tensor,
                       mark, timers: dict | None) -> tuple:
    """The five MSMs over this rank's query slices -> the G1 results
    (h, a, b1, c stacked, (4 b,)) and b2 (b,), the same on every rank of
    its "msm" group.

    Each MSM is the shard_window_sums of its slice (a dense msm_sorted,
    as the sharded path takes no signal plan, like the JAX package's), and
    combine_window_sums gathers, reduces and Horner-combines them, the two
    steps of parallel/sharding.py::sharded_sort_msm: the four G1 MSMs'
    sums stacked in one call, b2's in another, so the tails cost two
    chains of c * windows additions, not five. h_t is already this shard's
    block, so the h MSM runs msm_sorted on it directly; the c MSM takes w_t[:, :, n_public + 1:] against the unpadded c
    query."""
    sharded = _shard_crs(mesh, pk)
    S = axis_size(mesh, "msm")
    idx = mesh.get_local_rank("msm")

    def windows(ops, name, scal):
        q, n_pad = sharded[name]
        return shard_window_sums(ops, q, scal, n_pad, S, idx)

    g1 = [MS.msm_sorted(CT.FQ_OPS, sharded["h_query"][0], h_t, tail=False)]
    mark("msm_h_s")
    g1.append(windows(CT.FQ_OPS, "a_query", w_t))
    mark("msm_a_s")
    b2 = windows(CT.FQ2_OPS, "b2_query", w_t)
    mark("msm_b2_s")
    g1.append(windows(CT.FQ_OPS, "b1_query", w_t))
    mark("msm_b1_s")
    g1.append(windows(CT.FQ_OPS, "c_query", w_t[:, :, pk.n_public + 1 :]))
    mark("msm_c_s")
    group = mesh.get_group("msm")
    out = tuple(combine_window_sums(ops, sums, group, MS.C_BITS_SORT, timers)
                for ops, sums in ((CT.FQ_OPS, concat_points(g1, dim=0)), (CT.FQ2_OPS, b2)))
    mark("msm_tail_s")
    return out


def _prove_sharded(pk: ProvingKey, cc, witnesses: torch.Tensor, mesh,
                   timers: dict | None):
    """The device part of proving on a (dp, msm) mesh: witnesses
    (L, n_signals, B), the whole batch on every rank -> the five
    pre-blinding MSM results of the whole batch as host point lists, the
    same on every rank. This rank proves its dp slice of the batch over
    its msm slice of the queries; the h stage's NTTs shard over "msm" when
    msm > 1 (else each rank runs the unsharded h stage on its slice); the
    points are gathered over "dp" at the end."""
    dp, S = axis_size(mesh, "dp"), axis_size(mesh, "msm")
    bsz = witnesses.shape[2]
    if bsz % dp:
        raise ValueError(f"batch size {bsz} must be divisible by dp={dp}")
    check_ntt_shards(pk.domain_log2, S)
    mark = _marker(pk, timers)
    w_loc = dp_sharded_inputs(mesh, {"w": witnesses})["w"]
    if S > 1:
        h_t, w_t = _h_stage_mesh(pk, cc, w_loc, mesh, timers), w_loc.movedim(2, 1)
    else:
        h_t, w_t = msm_scalars(pk, cc, w_loc)
    mark("h_stage_s")
    g1, b2 = _msm_stage_sharded(pk, mesh, w_t, h_t, mark, timers)
    del h_t
    group = mesh.get_group("dp")
    b = bsz // dp
    g1 = gather_points(g1, group, timers)  # per dp rank: h, a, b1, c of its b proofs
    h, a, b1, c = (concat_points([map_coords(p, lambda t, k=k: t[:, k * b : (k + 1) * b])
                                  for p in g1], dim=0) for k in range(4))
    b2 = concat_points(gather_points(b2, group, timers), dim=0)
    return _results_to_host(a, b2, b1, c, h, bsz)


def blind(pk: ProvingKey, points, witnesses: torch.Tensor, rng: random.Random):
    """The five pre-blinding MSM results of a batch (as prove_points returns
    them) -> one (proof, public_inputs) per batch element: the r/s blinding
    on the host, r then s drawn from rng per proof, in the JAX package's
    order."""
    a_l, b2_l, b1_l, c_l, h_l = points
    w_pub = LB.limbs_to_ints(witnesses[:, 1 : pk.n_public + 1, :])
    out = []
    for i in range(witnesses.shape[2]):
        r = rng.randrange(P)
        s = rng.randrange(P)
        a_pt = a_l[i].add(pk.alpha_g1).add(pk.delta_g1.mul(r))
        b_pt = b2_l[i].add(pk.beta_g2).add(pk.delta_g2.mul(s))
        b1_pt = b1_l[i].add(pk.beta_g1).add(pk.delta_g1.mul(s))
        c_pt = (
            c_l[i]
            .add(h_l[i])
            .add(a_pt.mul(s))
            .add(b1_pt.mul(r))
            .add(pk.delta_g1.mul((-r * s) % P))
        )
        publics = [int(v) for v in w_pub[:, i]]
        out.append((Proof(a_pt, b_pt, c_pt), publics))
    return out


@torch.inference_mode()
def prove_batch(
    pk: ProvingKey,
    cc,
    witnesses,
    rng: random.Random | None = None,
    timers: dict | None = None,
    device=None,
    mesh=None,
) -> list[tuple[Proof, list[int]]]:
    """Prove a batch of witnesses (L, n_signals, B) (standard-form limbs,
    numpy or tensor) on `device` (default: CUDA; the key must live there).

    Returns one (proof, public_inputs) per batch element. `timers`, when
    given, receives the stage times h_stage_s and msm_{h,a,b2,b1,c}_s, and
    plan: each signal MSM's outcome under the key's signal plan ("hit", or
    "miss": proved dense, plan rebuilt).

    With `mesh` (a (dp, msm) DeviceMesh, parallel/sharding.py::make_mesh),
    every rank of the mesh calls prove_batch with the whole batch: the
    batch shards over "dp" (B divisible by dp), the five MSMs over "msm"
    and, when msm > 1, the h polynomial's NTTs over "msm" (msm a power of
    two). Every rank blinds the whole batch with its own rng, so under
    the same seeded rng every rank returns the same proofs, bit for bit
    those of the unsharded prove. `timers` then also holds gather_s, the
    seconds in collectives, and no plan (the sharded MSMs are dense)."""
    dev = resolve_device(device)
    if pk.device != dev:
        raise ValueError(f"proving key lives on {pk.device}, prove asked for {dev}")
    witnesses = LB.to_device(witnesses, dev)
    if witnesses.dim() != 3 or witnesses.shape[:2] != (L, cc.n_signals):
        raise ValueError(
            f"witnesses must be (L={L}, n_signals={cc.n_signals}, B); "
            f"got {tuple(witnesses.shape)}"
        )
    if mesh is None:
        points = prove_points(pk, cc, witnesses, timers)
    elif mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot prove on {dev}")
    else:
        points = _prove_sharded(pk, cc, witnesses, mesh, timers)
    return blind(pk, points, witnesses, rng or random.SystemRandom())


def prove(pk: ProvingKey, cc, witness, rng: random.Random | None = None,
          device=None) -> tuple[Proof, list[int]]:
    """witness: (L, n_signals) standard-form limbs (one email). Returns
    (proof, public_inputs); the same proof as prove_batch on a batch of
    one, and as the JAX package's prove under the same `rng`."""
    dev = resolve_device(device)
    w = LB.to_device(witness, dev)
    return prove_batch(pk, cc, w.unsqueeze(2), rng=rng, device=dev)[0]
