"""Device-mesh parallelism for the prover, on ``torch.distributed``.

The port of ``zkemail_tpu/parallel/sharding.py``. A mesh has two axes:

  * "dp": the proofs of a batch split across ranks (each rank proves its
    slice of the batch axis);
  * "msm": one proof's work split across ranks: each rank runs the
    sort/telescope MSM (``ops/msm_sort.py``) over its slice of every point
    query, the per-rank partial sums are all-gathered over "msm" and added
    in rank order with the exact complete addition (K2/K3), so the sum is
    the same group element for every shard count; and the h polynomial's
    iNTT -> sigma shift -> NTT runs as a four-step NTT across the "msm"
    ranks, one all-gather per NTT.

The JAX package drives a mesh from one controller through ``shard_map``;
here every rank is its own process (``parallel/launch.py``) and runs the
functions below on its own shard, with collectives over the mesh's process
groups. A rank's "local" arrays are its shard; nothing holds the global
array. Ranks are laid out row-major over (dp, msm), as the JAX package's
``np.array(devs).reshape(dp, msm)``, so a rank's coordinate on an axis is
also its rank in that axis's process group (groups list ranks in ascending
order), and an all-gather returns the shards in coordinate order.

Gathers run on NCCL between cards. Under gloo (the CPU tests, or ranks
sharing one card) they copy through host memory, which is what gloo moves.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..core import curve_torch as CT
from ..core import field as F
from ..core import limbs as LB
from ..ops import msm_sort as MS
from ..ops import ntt as NTT
from ..ops.msm import _first, _horner_combine, concat_points, map_coords

AXES = ("dp", "msm")
L = F.LIMBS
P = F.R
FS = LB.FR_SPEC


def mesh_shape(n: int, dp: int | None = None) -> tuple[int, int]:
    """(dp, msm) of a mesh over n devices: by default the largest power of
    two dp with dp <= msm (the JAX package's make_mesh rule); the mesh
    covers dp * (n // dp) devices."""
    if n < 1 or (dp is not None and not 1 <= dp <= n):
        raise ValueError(f"no mesh of {n} devices with dp={dp}")
    if dp is None:
        dp = 1
        while dp * 2 <= n and n % (dp * 2) == 0 and dp * 2 <= n // (dp * 2):
            dp *= 2
    return dp, n // dp


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device_type: str = "cuda", backend: str | None = None):
    """A ``DeviceMesh`` with mesh_dim_names ("dp", "msm") over the ranks of
    the initialized process group, laid out row-major. Every rank calls it.

    The mesh must cover the whole group (n_devices defaults to its size).
    backend: the process group's backend the caller expects, by default
    NCCL for device_type "cuda" and gloo for "cpu"; pass "gloo" to run a
    CUDA mesh over gloo (ranks sharing one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/launch.py::spawn)")
    world = dist.get_world_size()
    dp, msm = mesh_shape(n_devices or world, dp)
    if dp * msm != world:
        raise ValueError(f"a ({dp}, {msm}) mesh must cover the process group's "
                         f"{world} ranks")
    want = backend or ("nccl" if device_type == "cuda" else "gloo")
    if dist.get_backend() != want:
        raise ValueError(f"a {device_type} mesh expects backend {want}; the process "
                         f"group runs {dist.get_backend()}")
    return init_device_mesh(device_type, (dp, msm), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def all_gather_stack(t: torch.Tensor, group, timers: dict | None = None) -> torch.Tensor:
    """t (rows, ...) from every rank of `group` -> (S, rows, ...) in group
    rank order, on t's device. The collective writes one buffer of the
    shards concatenated along dim 0. timers, when given, accumulates the
    seconds of the gather (the device synchronized on both sides) under
    "gather_s"."""
    sync = ((lambda: torch.cuda.synchronize(t.device)) if t.device.type == "cuda"
            else (lambda: None))
    if timers is not None:
        sync()
        t0 = time.time()
    src = t.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    S = dist.get_world_size(group)
    out = torch.empty((S * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with warnings.catch_warnings():
        # deprecated in favour of all_gather_single, which older releases lack
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    out = out.view((S,) + tuple(src.shape)).to(t.device)
    if timers is not None:
        sync()
        timers["gather_s"] = timers.get("gather_s", 0.0) + time.time() - t0
    return out


def _coords(pt: dict) -> list:
    return [c for k in "xyz" for c in (pt[k] if isinstance(pt[k], tuple) else (pt[k],))]


def _uncoords(pt: dict, cs) -> dict:
    """A point dict shaped like pt from its coordinates in _coords order."""
    if isinstance(pt["x"], tuple):
        return {k: (cs[2 * i], cs[2 * i + 1]) for i, k in enumerate("xyz")}
    return {k: cs[i] for i, k in enumerate("xyz")}


def gather_points(pt: dict, group, timers: dict | None = None) -> list:
    """A point batch from every rank of `group` -> one point dict per rank,
    in group rank order (one collective for all coordinates)."""
    g = all_gather_stack(torch.stack(_coords(pt)), group, timers)
    return [_uncoords(pt, list(g[i].unbind(0))) for i in range(g.shape[0])]


def reduce_gathered(ops, part: dict, group, timers: dict | None = None) -> dict:
    """The sum over the ranks of `group` of their partial sums `part`:
    gathered, then added in rank order 0..S-1 by the complete addition, so
    every rank holds the same points."""
    parts = gather_points(part, group, timers)
    acc = parts[0]
    for nxt in parts[1:]:
        acc = CT.ec_add(ops, acc, nxt)
    return acc


def shard_local_points(ops, points: dict, n_pad: int, n_msm: int, idx: int) -> dict:
    """Shard idx's slice of a point query (n,) padded to n_pad with the
    identity (0, 1, 0): the neutral element leaves any sum it enters, under
    every route. Returns contiguous copies."""
    n = _first(points).shape[1]
    n_loc = n_pad // n_msm
    lo, hi = idx * n_loc, (idx + 1) * n_loc
    part = map_coords(points, lambda c: c[:, lo:min(hi, n)])
    if hi > n:
        dev = _first(points).device
        part = concat_points([part, CT.ec_identity(ops, (hi - max(lo, n),), dev)], dim=0)
    return map_coords(part, lambda c: c.contiguous())


def shard_local_scalars(scal: torch.Tensor, n_pad: int, n_msm: int, idx: int) -> torch.Tensor:
    """Shard idx's slice of scalars (L, B, n) zero-padded to n_pad (the
    JAX package's ``prover/groth16.py::_shard_local_scalars``)."""
    n_loc = n_pad // n_msm
    pad = n_pad - scal.shape[2]
    if pad:
        scal = torch.nn.functional.pad(scal, (0, pad))
    return scal[:, :, idx * n_loc : (idx + 1) * n_loc]


def shard_window_sums(ops, points_loc: dict, scalars: torch.Tensor, n_pad: int,
                      n_msm: int, idx: int, c_bits: int,
                      k_block: int = MS.K_BLOCK) -> dict:
    """Shard idx's per-window sums (B, n_windows): its point slice
    points_loc (shard_local_points) against its slice of the scalars
    (L, B, n), through msm_sorted at window c_bits stopped before the
    Horner combination. Every shard takes the same window: the caller's,
    from the whole width, never from the slice's."""
    return MS.msm_sorted(ops, points_loc, shard_local_scalars(scalars, n_pad, n_msm, idx),
                         c_bits=c_bits, k_block=k_block, tail=False)


def combine_window_sums(ops, sums: dict, group, c_bits: int,
                        timers: dict | None = None) -> dict:
    """This rank's per-window sums (B, n_windows) -> the MSM over every
    shard of `group`, (B,): the sums gathered and added in rank order
    (reduce_gathered), then one Horner combination."""
    return _horner_combine(ops, reduce_gathered(ops, sums, group, timers),
                           MS.n_windows_for(c_bits), c_bits)


def sharded_sort_msm(mesh, ops, points: dict, scalars: torch.Tensor,
                     c_bits: int | None = None, k_block: int = MS.K_BLOCK) -> dict:
    """The "msm"-sharded sort/telescope MSM: points (n,) and scalars
    (L, B, n), the same on every rank, padded to a multiple of the shard
    count (identity points, zero scalars); this rank's slice goes through
    shard_window_sums, and combine_window_sums adds the ranks' sums. The
    prover's sharded MSM stage runs the same two steps. Returns the point
    batch (B,) on every rank, at window c_bits (None: window_bits(n))."""
    S = axis_size(mesh, "msm")
    idx = mesh.get_local_rank("msm")
    n = _first(points).shape[1]
    c_bits = c_bits or MS.window_bits(n)
    n_pad = -(-n // S) * S
    sums = shard_window_sums(ops, shard_local_points(ops, points, n_pad, S, idx), scalars,
                             n_pad, S, idx, c_bits, k_block)
    return combine_window_sums(ops, sums, mesh.get_group("msm"), c_bits)


def dp_sharded_inputs(mesh, inputs: dict) -> dict:
    """This rank's slice of the batch (last) axis of each input."""
    dp = axis_size(mesh, "dp")
    r = mesh.get_local_rank("dp")
    out = {}
    for k, v in inputs.items():
        bsz = v.shape[-1]
        if bsz % dp:
            raise ValueError(f"batch size {bsz} of {k} must be divisible by dp={dp}")
        b = bsz // dp
        out[k] = v[..., r * b : (r + 1) * b]
    return out


# ---------------------------------------------------------------------------
# "msm"-sharded NTT: the four-step decomposition
# ---------------------------------------------------------------------------
#
# A length-m NTT over S shards (m2 = m / S) splits as
#   NTT_m = (cross-shard DFT_S) . (rank-local twiddle) . (local NTT_m2):
# with i = i1 m2 + i2 (block input: shard s holds i1 = s) and k = k1 + S k2
# (cyclic output: shard s holds k1 = s),
#   X_{k1 + S k2} = sum_{i2} w^{i2 k1} w_m2^{i2 k2} [sum_{i1} w_S^{i1 k1} x_{i1, i2}].
# The inner S-point DFT is one all-gather over "msm" and an S-term weighted
# sum; the rest is local. The inverse runs the same split with w -> w^-1,
# 1/m as (1/m2 in the local iNTT) * (1/S in the cross twiddles). The h
# stage composes block -iNTT-> cyclic -sigma-> -NTT-> block, so its
# evaluations land block-distributed, as the h query is sharded.

def _mont_col(values: list, device) -> torch.Tensor:
    """(L, len(values)) Montgomery limbs of host Fr ints."""
    arr = np.array([F.FR.to_mont(v % P) for v in values], dtype=object)
    return torch.as_tensor(LB.ints_to_limbs(arr), device=device)


def own_ntt_tables(log_m: int, n_shards: int, idx: int, device) -> dict:
    """Shard idx's rows of the four-step tables, as (L, ...) Montgomery limbs
    on `device`: cross_fwd / cross_inv (L, S) w_S^{+-i1 idx} (inv times
    1/S), local_fwd / local_inv (L, m2) w^{+-idx b} and shift_cyclic
    (L, m2) sigma^(idx + S k2). The m2-long rows are built on the device by
    doubling (ops/ntt.py::powers), log2(m2) Montgomery products each."""
    S = n_shards
    m2 = (1 << log_m) // S
    w = F.fr_nth_root(log_m)
    w_inv = pow(w, P - 2, P)
    w_s = pow(w, m2, P)
    w_s_inv = pow(w_s, P - 2, P)
    s_inv = pow(S, P - 2, P)
    sigma = F.fr_nth_root(log_m + 1)
    return {
        "cross_fwd": _mont_col([pow(w_s, i1 * idx, P) for i1 in range(S)], device),
        "cross_inv": _mont_col([pow(w_s_inv, i1 * idx, P) * s_inv for i1 in range(S)],
                               device),
        "local_fwd": NTT.powers(pow(w, idx, P), m2, device),
        "local_inv": NTT.powers(pow(w_inv, idx, P), m2, device),
        "shift_cyclic": LB.mont_mul(FS, NTT.powers(pow(sigma, S, P), m2, device),
                                    _mont_col([pow(sigma, idx, P)], device)),
    }


def shard_ntt_tables(log_m: int, n_shards: int) -> dict:
    """Every shard's four-step tables in the JAX package's layout: numpy
    int32 Montgomery limbs cross_fwd / cross_inv (S, S, L) and local_fwd /
    local_inv / shift_cyclic (S, m2, L), row s being own_ntt_tables(s)."""
    rows = [own_ntt_tables(log_m, n_shards, s, "cpu") for s in range(n_shards)]
    return {k: np.stack([r[k].T.numpy() for r in rows]) for k in rows[0]}


def _cross_dft(x_loc: torch.Tensor, tw_own: torch.Tensor, group,
               timers: dict | None = None) -> torch.Tensor:
    """S-point DFT along the shard axis: x_loc (L, m2, ...) from every shard,
    gathered, times this shard's twiddle row tw_own (L, S) (one K1 launch
    for all S), summed in shard order. Returns (L, m2, ...)."""
    g = all_gather_stack(x_loc, group, timers)  # (S, L, m2, ...)
    S = g.shape[0]
    tw = tw_own.reshape((L, S) + (1,) * (x_loc.dim() - 1))
    terms = LB.mont_mul(FS, g.movedim(0, 1), tw)  # (L, S, m2, ...)
    acc = terms[:, 0]
    for i1 in range(1, S):
        acc = LB.add(FS, acc, terms[:, i1])
    return acc


def _local_mul(x_loc: torch.Tensor, table_own: torch.Tensor) -> torch.Tensor:
    """Pointwise product with this shard's (L, m2) twiddle row."""
    return LB.mont_mul(FS, x_loc, table_own.reshape(table_own.shape + (1,) * (x_loc.dim() - 2)))


def intt_block_to_cyclic(x_loc, tables_own: dict, plan_local: dict, group,
                         timers: dict | None = None) -> torch.Tensor:
    """Inverse NTT: block-distributed values -> cyclically distributed
    coefficients (coefficient k1 + S k2 on shard k1)."""
    y = _cross_dft(x_loc, tables_own["cross_inv"], group, timers)
    y = _local_mul(y, tables_own["local_inv"])
    return NTT.ntt(y, inverse=True, plan=plan_local)


def ntt_cyclic_to_block(x_loc, tables_own: dict, plan_local: dict, group,
                        timers: dict | None = None) -> torch.Tensor:
    """Forward NTT: cyclic coefficients -> block-distributed evaluations (the
    mirror of intt_block_to_cyclic)."""
    y = NTT.ntt(x_loc, inverse=False, plan=plan_local)
    y = _local_mul(y, tables_own["local_fwd"])
    return _cross_dft(y, tables_own["cross_fwd"], group, timers)


def shift_scale_cyclic(x_loc, tables_own: dict) -> torch.Tensor:
    """sigma^index scale of cyclically distributed coefficients (the
    CircomReduction domain shift of the h stage)."""
    return _local_mul(x_loc, tables_own["shift_cyclic"])


def check_ntt_shards(log_m: int, n_shards: int) -> int:
    """log2 of the local NTT length; raises unless the shard count is a
    power of two dividing the domain."""
    if n_shards & (n_shards - 1) or n_shards > 1 << log_m:
        raise ValueError(f"the four-step NTT needs a power-of-two shard count "
                         f"dividing 2^{log_m}; got {n_shards}")
    return log_m - (n_shards.bit_length() - 1)


def mesh_ntt_consts(mesh, log_m: int, device) -> tuple:
    """(tables, plan_local) of this rank's four-step NTT over a 2^log_m
    domain: its own_ntt_tables and the local NTT's domain plan."""
    S = axis_size(mesh, "msm")
    log_m2 = check_ntt_shards(log_m, S)
    return (own_ntt_tables(log_m, S, mesh.get_local_rank("msm"), device),
            NTT.domain_plan(log_m2, device))


def sharded_h_eval(mesh, values: torch.Tensor, log_m: int, consts: tuple | None = None,
                   timers: dict | None = None) -> torch.Tensor:
    """This rank's block (L, m / S, ...) of values block-sharded over "msm"
    -> the same block of the evaluations of their interpolant on sigma*D:
    iNTT, sigma shift, NTT, two gathers. The blocks together equal
    NTT.shifted_ntt(NTT.ntt(values, inverse=True)) bit for bit, for every
    shard count. consts: mesh_ntt_consts(mesh, log_m, values' device),
    made here when not given."""
    S = axis_size(mesh, "msm")
    log_m2 = check_ntt_shards(log_m, S)
    if values.shape[1] != 1 << log_m2:
        raise ValueError(f"values hold {values.shape[1]} points; the block of "
                         f"2^{log_m} over {S} shards is {1 << log_m2}")
    tables, plan = consts or mesh_ntt_consts(mesh, log_m, values.device)
    group = mesh.get_group("msm")
    c = intt_block_to_cyclic(values, tables, plan, group, timers)
    c = shift_scale_cyclic(c, tables)
    return ntt_cyclic_to_block(c, tables, plan, group, timers)
