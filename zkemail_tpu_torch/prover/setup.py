"""Groth16 trusted setup (per-circuit CRS generation) on the card.

The port of ``zkemail_tpu/prover/setup.py``. For the same circuit and seed
it gives the JAX package's CRS point for point. What differs is where the
QAP evaluation at tau runs: the JAX package loops over Python ints (the
Lagrange column, a sequential batch inversion, and the per-entry column
sums), which takes minutes at a 2^21 domain; here it is tensor code on the
setup's device:

  * the Lagrange column L_i(tau) = Z(tau) w^i / (m (tau - w^i)) from the
    powers of w (doubling products) and an element-wise Fermat inverse;
  * u, v, w per signal as gather -> Montgomery product -> ``index_add_``
    over the matrix entries (the prover's QAP matvec with rows and columns
    swapped), summed in int64 because a column (the constant signal) may
    hold millions of entries;
  * the query points by ``fixed_base_batch`` through K2/K3.

Like snarkjs' `groth16 setup` without a ceremony, the toxic waste lives in
process memory: fine for proving infrastructure and benchmarks.
"""

from __future__ import annotations

import hashlib
import os
import random
import shutil
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core import field as F
from ..core import limbs as LB
from ..core.curve import G1, G2
from ..device import resolve_device
from ..ops import ntt as NTT
from ..ops.msm import fixed_base_batch
from .containers import VerifyingKey

P = F.R
FS = LB.FR_SPEC
L = F.LIMBS


@dataclass
class ProvingKey:
    domain_log2: int
    n_public: int
    # host points
    alpha_g1: G1
    beta_g1: G1
    beta_g2: G2
    delta_g1: G1
    delta_g2: G2
    # device point tables (projective point dicts)
    a_query: dict
    b1_query: dict
    b2_query: dict
    c_query: dict  # for signals n_public+1 .. n_signals-1
    h_query: dict
    vk: VerifyingKey = None
    # constraint count of the R1CS, without the n_public+1 instance rows
    # the QAP appends: the h stage places the instance values at rows
    # n_constraints.. (compute_h)
    n_constraints: int = 0
    device: torch.device = torch.device("cpu")
    # per-circuit tensors the prover derives once (prover/groth16.py)
    cache: dict = field(default_factory=dict, repr=False, compare=False)


def domain_log2_for(cc) -> int:
    """Domain size covering the R1CS rows PLUS the n_public+1 virtual
    instance rows (standard Groth16 / snarkjs sizing)."""
    m = 1
    log_m = 0
    while m < max(cc.n_constraints + cc.n_public + 1, 2):
        m *= 2
        log_m += 1
    return log_m


def fr_const(x: int, device) -> torch.Tensor:
    """(L, 1) Montgomery limbs of one Fr value."""
    return torch.tensor(F.to_limbs(F.FR.to_mont(x % P)), dtype=torch.int32,
                        device=device).reshape(L, 1)


def matrix_pack(cc, which: str, device) -> tuple:
    """One R1CS matrix on `device`: (rows, cols, Montgomery coeff limbs),
    cached on the circuit."""
    key = ("mat", which, str(device))
    if key not in cc.cache:
        rows, cols, cfs = getattr(cc, which)
        coeff = LB.to_device(LB.ints_to_limbs(np.asarray(cfs, dtype=object)), device)
        cc.cache[key] = (
            torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device),
            torch.as_tensor(np.asarray(cols, dtype=np.int64), device=device),
            LB.to_mont(FS, coeff),
        )
    return cc.cache[key]


def reduce_wide(acc: torch.Tensor) -> torch.Tensor:
    """(L, n) int64 limb sums of Montgomery-form values -> canonical
    Montgomery limbs of the sum mod p.

    After carry propagation the value is lo + hi * 2^264 with lo < 2^264;
    mont_mul(lo, R mod p) = lo mod p and mont_mul(hi, R^2 mod p) =
    hi * 2^264 mod p."""
    limbs = []
    carry = torch.zeros_like(acc[0])
    for i in range(L):
        v = acc[i] + carry
        limbs.append(v & F.LIMB_MASK)
        carry = v >> F.LIMB_BITS
    lo = torch.stack(limbs).to(torch.int32)
    hi = torch.stack([(carry >> (F.LIMB_BITS * i)) & F.LIMB_MASK for i in range(L)])
    r1 = torch.tensor(FS.r_limbs, dtype=torch.int32, device=acc.device)[:, None]
    r2 = torch.tensor(FS.r2_limbs, dtype=torch.int32, device=acc.device)[:, None]
    return LB.add(FS, LB.mont_mul(FS, lo, r1), LB.mont_mul(FS, hi.to(torch.int32), r2))


def lagrange_at(tau: int, log_m: int, device) -> torch.Tensor:
    """(L, m) Montgomery limbs of L_i(tau) = Z(tau) w^i / (m (tau - w^i))."""
    m = 1 << log_m
    omegas = NTT.powers(F.fr_nth_root(log_m), m, device)
    inv_d = LB.inv(FS, LB.sub(FS, fr_const(tau, device), omegas))
    z_tau = (pow(tau, m, P) - 1) % P
    scale = z_tau * pow(m, P - 2, P) % P
    return LB.mont_mul(FS, LB.mont_mul(FS, omegas, inv_d), fr_const(scale, device))


def qap_evaluations(cc, tau: int, device):
    """u_j(tau), v_j(tau), w_j(tau) for every signal j, as (L, n_signals)
    Montgomery limbs on `device`; also log_m and Z(tau).

    Includes the standard Groth16 instance rows: virtual constraint row
    n_constraints + s carries public signal s in the A matrix only."""
    log_m = domain_log2_for(cc)
    m = 1 << log_m
    lag = lagrange_at(tau, log_m, device)
    out = []
    for which in ("A", "B", "C"):
        rows, cols, coeff = matrix_pack(cc, which, device)
        prods = LB.mont_mul(FS, coeff, lag[:, rows])
        acc = torch.zeros((L, cc.n_signals), dtype=torch.int64, device=device)
        acc.index_add_(1, cols, prods.to(torch.int64))
        out.append(reduce_wide(acc))
    u, v, w = out
    npub1 = cc.n_public + 1
    inst = lag[:, cc.n_constraints : cc.n_constraints + npub1]
    u = torch.cat([LB.add(FS, u[:, :npub1], inst), u[:, npub1:]], dim=1)
    z_tau = (pow(tau, m, P) - 1) % P
    return u, v, w, log_m, z_tau


@torch.inference_mode()
def groth16_setup(cc, seed: int = 0, device=None) -> ProvingKey:
    """The CRS of circuit `cc` for `seed`, on `device` (default: CUDA)."""
    dev = resolve_device(device)
    rng = random.Random(seed or None)
    tau = rng.randrange(1, P)
    alpha = rng.randrange(1, P)
    beta = rng.randrange(1, P)
    gamma = rng.randrange(1, P)
    delta = rng.randrange(1, P)

    u, v, w, log_m, _ = qap_evaluations(cc, tau, dev)
    m = 1 << log_m
    n_pub = cc.n_public
    gamma_inv = pow(gamma, P - 2, P)
    delta_inv = pow(delta, P - 2, P)

    # k_j = beta u_j + alpha v_j + w_j
    k = LB.add(FS, LB.add(FS, LB.mont_mul(FS, u, fr_const(beta, dev)),
                          LB.mont_mul(FS, v, fr_const(alpha, dev))), w)
    ic_scalars = [
        int(x) * gamma_inv % P
        for x in LB.limbs_to_ints(LB.from_mont(FS, k[:, : n_pub + 1]))
    ]
    c_scalars = LB.mont_mul(FS, k[:, n_pub + 1 :], fr_const(delta_inv, dev))
    # h query scalars in snarkjs' CircomReduction basis: H_i embeds the
    # odd-indexed Lagrange polynomial over the DOUBLE domain at tau,
    #   s_i = Z_{2m}(tau) x_i / (2m (tau - x_i) delta),  x_i = sigma w^i
    sigma = F.fr_nth_root(log_m + 1)
    xs = LB.mont_mul(FS, NTT.powers(F.fr_nth_root(log_m), m, dev), fr_const(sigma, dev))
    inv_d = LB.inv(FS, LB.sub(FS, fr_const(tau, dev), xs))
    z2_tau = (pow(tau, 2 * m, P) - 1) % P
    coef = z2_tau * pow(2 * m, P - 2, P) % P * delta_inv % P
    h_scalars = LB.mont_mul(FS, LB.mont_mul(FS, xs, inv_d), fr_const(coef, dev))

    def std(x):
        return LB.from_mont(FS, x)

    a_query = fixed_base_batch("g1", std(u))
    b1_query = fixed_base_batch("g1", std(v))
    b2_query = fixed_base_batch("g2", std(v))
    c_query = fixed_base_batch("g1", std(c_scalars))
    h_query = fixed_base_batch("g1", std(h_scalars))
    ic_pts = [G1.generator().mul(s) for s in ic_scalars]

    g1, g2 = G1.generator(), G2.generator()
    vk = VerifyingKey(
        alpha_g1=g1.mul(alpha),
        beta_g2=g2.mul(beta),
        gamma_g2=g2.mul(gamma),
        delta_g2=g2.mul(delta),
        ic=ic_pts,
    )
    return ProvingKey(
        domain_log2=log_m,
        n_public=n_pub,
        alpha_g1=g1.mul(alpha),
        beta_g1=g1.mul(beta),
        beta_g2=g2.mul(beta),
        delta_g1=g1.mul(delta),
        delta_g2=g2.mul(delta),
        a_query=a_query,
        b1_query=b1_query,
        b2_query=b2_query,
        c_query=c_query,
        h_query=h_query,
        vk=vk,
        n_constraints=cc.n_constraints,
        device=dev,
    )


def setup_cache_key(cc, seed: int) -> str:
    """The JAX package's CRS cache key for (circuit, seed): name, counts, a
    digest of the constraint coefficients and the seed, so any circuit
    change misses."""
    h = hashlib.sha256()
    for rows, cols, cfs in (cc.A, cc.B, cc.C):
        h.update(np.ascontiguousarray(rows).tobytes())
        h.update(np.ascontiguousarray(cols).tobytes())
        h.update(len(cfs).to_bytes(8, "little"))
        for cf in list(cfs[:64]) + list(cfs[-64:]):
            h.update((int(cf) % (1 << 256)).to_bytes(32, "little"))
    digest = h.hexdigest()[:12]
    return f"pk3_{cc.name}_{cc.n_constraints}_{cc.n_signals}_{digest}_{seed}"


def groth16_setup_cached(cc, seed: int = 0, cache_dir: str | None = None,
                         device=None) -> ProvingKey:
    """Disk-cached setup: the CRS for a fixed (circuit, seed) is immutable.

    The key is stored as a chunked artifact (``prover/artifacts.py``) in
    the directory ``<cache_dir>/<setup_cache_key>.chunked``, beside which a
    JAX package's ``.pkl`` of the same key can live; a hit loads it onto
    `device` (default: CUDA) with an empty cache."""
    from .artifacts import export_chunked, load_chunked

    dev = resolve_device(device)
    if not cache_dir:
        return groth16_setup(cc, seed, device=dev)
    path = Path(cache_dir) / f"{setup_cache_key(cc, seed)}.chunked"
    if (path / "pk.manifest.json").exists():
        return load_chunked(str(path), "pk", device=dev)
    pk = groth16_setup(cc, seed, device=dev)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    export_chunked(pk, str(tmp), name="pk")
    try:
        tmp.rename(path)
    except OSError:  # another process stored the same key first
        shutil.rmtree(tmp, ignore_errors=True)
    return pk
