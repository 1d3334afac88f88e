"""Radix-2 NTT over BN254 Fr on PyTorch limb tensors.

The port of ``zkemail_tpu/ops/ntt.py``, over (L, n, ...) Montgomery-form
values, dispatching on the values' device alone:

* a CUDA tensor runs kernel K4 (``ops/csrc/ntt_fr.cu``): the whole
  transform in ``len(ntt_passes(log2 n))`` launches, each counted in
  ``field_kernels.LAUNCHES["ntt"]``, with the bit reversal folded into the
  first pass, ``shifted_ntt``'s sigma^i scaling into the first and the
  inverse's 1/n into the last. Its tables (``kernel_plan``) are 8 x 32-bit
  words of w * 2^256 mod p;
* any other tensor runs the plain version, ``ntt_plain``: iterative
  Cooley-Tukey, each stage a reshape, one batched Montgomery multiply by the
  stage twiddles and an add/sub. The CPU tests hold it to the JAX package,
  and the card tests hold K4 to it.

The constant tables are built without per-element Python ints: the bit
reversal with numpy, and every table of powers (twiddles, coset and sigma
shifts) on the tables' device by repeated doubling, ``pw[k:2k] = pw[:k] *
base^k``, i.e. log2(n) Montgomery products. The values are those of the
JAX package's Python-int loops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import field as F
from ..core import limbs as LB
from . import field_kernels as FK
from . import kernel_build

L = F.LIMBS
P = F.R
FS = LB.FR_SPEC


def _mont_limbs(x: int, device) -> torch.Tensor:
    """(L, 1) Montgomery-form limbs of one Fr value."""
    return torch.tensor(F.to_limbs(F.FR.to_mont(x % P)), dtype=torch.int32,
                        device=device).reshape(L, 1)


def powers(base: int, count: int, device) -> torch.Tensor:
    """(L, count) Montgomery limbs of base^i, i < count, by doubling."""
    out = _mont_limbs(1, device)
    k, step = 1, base % P
    while k < count:
        take = min(k, count - k)
        nxt = LB.mont_mul(FS, out[:, :take], _mont_limbs(step, device))
        out = torch.cat([out, nxt], dim=1)
        k += take
        step = step * step % P
    return out[:, :count].contiguous()


def bit_reverse_perm(log_n: int) -> np.ndarray:
    """The bit-reversal permutation of range(2^log_n), vectorized."""
    idx = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def stage_twiddles(log_n: int, inverse: bool, device) -> tuple:
    """Per-stage Montgomery twiddles: stage s (m = 2^(s+1)) holds w_m^j for
    j < m/2, where w_m = w^(n/m) — the strided slice W[j * n/m] of the one
    table W = w^k, k < n/2."""
    n = 1 << log_n
    w = F.fr_nth_root(log_n)
    if inverse:
        w = pow(w, P - 2, P)
    table = powers(w, max(n // 2, 1), device)
    out = []
    for s in range(log_n):
        m = 1 << (s + 1)
        out.append(table[:, :: n // m][:, : m // 2].contiguous())
    return tuple(out)


def n_inv_mont(log_n: int, device) -> torch.Tensor:
    return _mont_limbs(pow(1 << log_n, P - 2, P), device)[:, 0]


def shift_powers(log_n: int, device) -> torch.Tensor:
    """Montgomery powers of sigma, the primitive 2^(log_n+1)-th root of
    unity: scaling coefficient i by sigma^i, then an NTT, evaluates on
    sigma*D, the domain of snarkjs' CircomReduction h polynomial."""
    return powers(F.fr_nth_root(log_n + 1), 1 << log_n, device)


def coset_powers(log_n: int, inverse: bool, device) -> torch.Tensor:
    g = F.FR_MULT_GENERATOR
    if inverse:
        g = pow(g, P - 2, P)
    return powers(g, 1 << log_n, device)


def plain_plan(log_n: int, device) -> dict:
    """Every constant of one domain for the plain version, on `device`."""
    return {
        "perm": torch.as_tensor(bit_reverse_perm(log_n), device=device),
        "tw_fwd": stage_twiddles(log_n, False, device),
        "tw_inv": stage_twiddles(log_n, True, device),
        "ninv": n_inv_mont(log_n, device),
        "shift": shift_powers(log_n, device),
    }


def ntt_plain(values: torch.Tensor, inverse: bool = False,
              plan: dict | None = None) -> torch.Tensor:
    """The plain version of ntt, on any device; `plan` is a plain_plan."""
    n = values.shape[1]
    rest = tuple(values.shape[2:])
    r1 = (1,) * len(rest)
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT length {n} is not a power of two")
    if plan is None:
        plan = plain_plan(log_n, values.device)
    tws = plan["tw_inv"] if inverse else plan["tw_fwd"]
    x = values[:, plan["perm"]]
    for s in range(log_n):
        m = 1 << (s + 1)
        half = m // 2
        xr = x.reshape((L, n // m, m) + rest)
        even = xr[:, :, :half]
        odd = xr[:, :, half:]
        t = LB.mont_mul(FS, odd, tws[s].reshape((L, 1, half) + r1))
        x = torch.cat([LB.add(FS, even, t), LB.sub(FS, even, t)], dim=2).reshape(
            (L, n) + rest
        )
    if inverse:
        x = LB.mont_mul(FS, x, plan["ninv"].reshape((L, 1) + r1))
    return x


# ---------------------------------------------------------------------------
# K4: the transform on the card
# ---------------------------------------------------------------------------

PASS_STAGES = 8  # most stages a K4 pass runs (ops/csrc/ntt_fr.cu: NTT_MAX_PASS)
WORD_SPLIT = 11  # power_words' exponent split: two tables of about 2^11


def ntt_passes(log_n: int) -> list:
    """(first stage, stages) of each K4 launch of a 2^log_n transform: the
    fewest passes of at most PASS_STAGES stages, the longer ones first."""
    count = -(-log_n // PASS_STAGES)
    size, extra = divmod(log_n, count)
    out, s0 = [], 0
    for i in range(count):
        k = size + (i < extra)
        out.append((s0, k))
        s0 += k
    return out


def power_words(base: int, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), 8) int32: the 32-bit words, least significant first, of
    base^i * 2^256 mod p for each i of the int64 tensor idx, on its device.
    base^(lo + hi 2^WORD_SPLIT) is one Montgomery product of an entry of
    base^lo (R form) and one of base^(hi 2^WORD_SPLIT) * 2^256 (that
    table's R form times 2^256 mod p, as a plain number)."""
    device = idx.device
    top = int(idx.max()) >> WORD_SPLIT if idx.numel() else 0
    lo = powers(base, 1 << WORD_SPLIT, device)
    hi = powers(pow(base, 1 << WORD_SPLIT, P), top + 1, device)
    to_256 = torch.tensor(F.to_limbs((1 << 256) % P), dtype=torch.int32, device=device)
    hi = LB.mont_mul(FS, hi, to_256[:, None])
    mask = (1 << WORD_SPLIT) - 1
    x = LB.mont_mul(FS, lo[:, idx & mask], hi[:, idx >> WORD_SPLIT])
    return LB.limbs_to_bytes(x).reshape(-1).view(torch.int32).reshape(-1, 8)  # little endian


def kernel_plan(log_n: int, device) -> dict:
    """K4's tables of one domain, on `device`, in the order its passes read
    them: W^e * 2^256 for e < n / 2 (forward W = w, inverse W = w^-1, w the
    primitive n-th root), sigma^i * 2^256 for i < n and n^-1 * 2^256."""
    n = 1 << log_n
    w = F.fr_nth_root(log_n)
    half = torch.arange(max(n // 2, 1), device=device)
    return {
        "log_n": log_n,
        "words_fwd": power_words(w, half),
        "words_inv": power_words(pow(w, P - 2, P), half),
        "words_ninv": power_words(pow(n, P - 2, P), torch.ones(1, dtype=torch.int64,
                                                                device=device)),
        "words_shift": power_words(F.fr_nth_root(log_n + 1), torch.arange(n, device=device)),
    }


def domain_plan(log_n: int, device) -> dict:
    """Every NTT/shift constant of one domain, on `device`: K4's tables
    (kernel_plan) on a CUDA device, the plain version's (plain_plan) on
    any other."""
    if torch.device(device).type == "cuda":
        return kernel_plan(log_n, device)
    return plain_plan(log_n, device)


def _ntt_kernel(values: torch.Tensor, inverse: bool, plan: dict | None,
                shift: bool = False) -> torch.Tensor:
    """K4 on (L, n, ...) int32 CUDA values, n >= 2 a power of two: one
    launch per ntt_passes entry into an output and an 8-word scratch it
    allocates. shift scales point i by sigma^i first; inverse scales by
    1/n last."""
    n = values.shape[1] if values.dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if n < 2 or 1 << log_n != n or values.dtype != torch.int32 or values.shape[0] != L:
        raise ValueError(f"K4 takes ({L}, n, ...) int32 limbs with n >= 2 a power of "
                         f"two, got {tuple(values.shape)} {values.dtype}")
    if plan is None:
        plan = kernel_plan(log_n, values.device)
    if plan.get("log_n") != log_n:
        raise ValueError(f"the plan is not K4's plan of a 2^{log_n} domain")
    tables = (plan["words_inv" if inverse else "words_fwd"],
              plan["words_shift"] if shift else None,
              plan["words_ninv"] if inverse else None)
    for t in tables:
        if t is not None and (t.device != values.device or not t.is_contiguous()):
            raise ValueError("K4's tables must be contiguous on the values' device")
    x = values.contiguous()
    out = torch.empty_like(x)
    lanes = x.numel() // (L * n)
    if lanes == 0:
        return out
    passes = ntt_passes(log_n)
    scratch = (torch.empty((n * lanes, 8), dtype=torch.int32, device=x.device)
               if len(passes) > 1 else None)
    ptrs = [None if t is None else t.data_ptr() for t in (scratch,) + tables]
    lib = kernel_build.library()
    for s0, k in passes:
        FK._launch("ntt", x.device, lib.zk_ntt_pass, x.data_ptr(), out.data_ptr(), *ptrs,
                   log_n, s0, k, lanes, FK._stream(x))
    return out


def ntt(values: torch.Tensor, inverse: bool = False, plan: dict | None = None) -> torch.Tensor:
    """NTT/iNTT of (L, n, ...) Montgomery-form Fr values, n a power of two.

    Axes after the polynomial axis are independent batch lanes. `plan`
    (domain_plan on the values' device) saves rebuilding the tables on
    every call. A CUDA tensor runs K4 (n >= 2), any other ntt_plain."""
    if values.device.type == "cuda":
        return _ntt_kernel(values, inverse, plan)
    return ntt_plain(values, inverse, plan)


def _scale(values: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    return LB.mont_mul(FS, values, pw.reshape(pw.shape + (1,) * (values.dim() - 2)))


def coset_scale(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Multiply coefficient i by g^i (or g^-i) — coset evaluation shift."""
    log_n = values.shape[1].bit_length() - 1
    return _scale(values, coset_powers(log_n, inverse, values.device))


def coset_ntt(coeffs: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    return ntt(coset_scale(coeffs), inverse=False, plan=plan)


def coset_intt(evals: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    return coset_scale(ntt(evals, inverse=True, plan=plan), inverse=True)


def shift_scale(values: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """Multiply coefficient i by sigma^i (sigma^2 = omega); `plan` is a
    plain_plan."""
    log_n = values.shape[1].bit_length() - 1
    pw = plan["shift"] if plan is not None else shift_powers(log_n, values.device)
    return _scale(values, pw)


def shifted_ntt(coeffs: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """Evaluate a coefficient vector on sigma*D (the CircomReduction domain):
    coefficient i scaled by sigma^i, then an NTT; on a CUDA tensor K4's
    first pass does the scaling."""
    if coeffs.device.type == "cuda":
        return _ntt_kernel(coeffs, False, plan, shift=True)
    return shifted_ntt_plain(coeffs, plan)


def shifted_ntt_plain(coeffs: torch.Tensor, plan: dict | None = None) -> torch.Tensor:
    """The plain version of shifted_ntt, on any device; `plan` is a plain_plan."""
    return ntt_plain(shift_scale(coeffs, plan=plan), inverse=False, plan=plan)
