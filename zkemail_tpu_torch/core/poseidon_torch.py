"""Batched Poseidon permutation over Fr on PyTorch tensors.

The port of ``zkemail_tpu/core/poseidon_jax.py``, for hashing many values
at once outside a circuit: the DKIM registry hashes every crawled key with
``pubkey_hashes``. Parameters come from ``core/poseidon.py`` (circomlib's),
so the outputs equal the Python-int ``poseidon`` bit for bit.

Layout: a batch of states is ``(L, t, B)`` Fr Montgomery limbs, limbs
leading, the width t in the middle and the batch on the last axis. Every
product is one K1 launch through ``core.limbs.mont_mul`` (its plain version
on a CPU tensor): the S-box x^5 as x^2, x^4, x^5, and the MDS mix as one
(L, t, t, B) product whose t_in axis is then summed by a tree of additions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from . import field as F
from . import limbs as LB
from .poseidon import N_ROUNDS_F, N_ROUNDS_P, poseidon_params

L = F.LIMBS
# poseidonLarge(modulus, 121, 9), the circuit's pubkeyHash: 9 merged chunks
# of 2 x 121 bits, hashed at width t = 10
PUBKEY_CHUNK_BITS = 242
PUBKEY_CHUNKS = 9


def _fold_add(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Tree-reduce field addition along batch axis `dim` (limb axis 0
    included in the count, so dim >= 1); the axis is kept with size 1."""
    fs = LB.FR_SPEC
    while x.shape[dim] > 1:
        k = x.shape[dim]
        half = k // 2
        s = LB.add(fs, x.narrow(dim, 0, half), x.narrow(dim, half, half))
        if k % 2:
            s = torch.cat([s, x.narrow(dim, 2 * half, 1)], dim=dim)
        x = s
    return x


@functools.lru_cache(maxsize=None)
def _mont_params(t: int):
    """Round constants (rounds, L, t) and MDS (L, t_out, t_in) in Montgomery
    limb form (numpy)."""
    consts, mds = poseidon_params(t)
    n_rounds = N_ROUNDS_F + N_ROUNDS_P[t - 2]
    pf = F.FR
    c = np.array(
        [[F.to_limbs(pf.to_mont(consts[r * t + i])) for i in range(t)]
         for r in range(n_rounds)],
        dtype=np.int32,
    )
    m = np.array(
        [[F.to_limbs(pf.to_mont(mds[i][j])) for j in range(t)] for i in range(t)],
        dtype=np.int32,
    )
    return np.moveaxis(c, -1, 1), np.moveaxis(m, -1, 0)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    fs = LB.FR_SPEC
    x2 = LB.mont_mul(fs, x, x)
    x4 = LB.mont_mul(fs, x2, x2)
    return LB.mont_mul(fs, x4, x)


def permute_torch(state: torch.Tensor) -> torch.Tensor:
    """The Poseidon permutation on a batch of states: (L, t, B) Fr
    Montgomery limbs in, the same shape out."""
    fs = LB.FR_SPEC
    t = state.shape[1]
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    c_np, m_np = _mont_params(t)
    consts = torch.from_numpy(c_np).to(state.device)[..., None]  # (rounds, L, t, 1)
    mds = torch.from_numpy(m_np).to(state.device)[..., None]  # (L, t_out, t_in, 1)

    def mix(s):
        # (L, t_out, t_in, 1) x (L, 1, t_in, B): one K1 launch at t * t * B lanes
        prod = LB.mont_mul(fs, mds, s[:, None, :, :])
        return _fold_add(prod, 2)[:, :, 0, :]

    half = r_f // 2
    s = state
    for r in range(r_f + r_p):
        s = LB.add(fs, s, consts[r])
        if half <= r < half + r_p:
            s = torch.cat([_sbox(s[:, :1, :]), s[:, 1:, :]], dim=1)
        else:
            s = _sbox(s)
        s = mix(s)
    return s


def poseidon_torch(inputs: torch.Tensor) -> torch.Tensor:
    """Batched circom-style hash: inputs (L, n, B) -> (L, B), Montgomery form
    in and out; state = [0, inputs...], the output is state[0] after the
    permutation."""
    zero = torch.zeros((L, 1, inputs.shape[2]), dtype=torch.int32, device=inputs.device)
    return permute_torch(torch.cat([zero, inputs], dim=1))[:, 0, :]


def pubkey_chunks(moduli) -> np.ndarray:
    """The 9 merged 242-bit chunks of each modulus (poseidon_large(n, 121, 9)
    reads bits 0..2177) as standard-form limbs (L, 9, B), by numpy bit
    slicing: a 242-bit chunk is its own 22 x 12-bit limbs."""
    bits_total = PUBKEY_CHUNK_BITS * PUBKEY_CHUNKS
    nbytes = (bits_total + 7) // 8
    mask = (1 << bits_total) - 1
    buf = b"".join((int(n) & mask).to_bytes(nbytes, "little") for n in moduli)
    u8 = np.frombuffer(buf, dtype=np.uint8).reshape(len(moduli), nbytes)
    bits = np.unpackbits(u8, axis=1, bitorder="little")[:, :bits_total]
    bits = bits.reshape(len(moduli), PUBKEY_CHUNKS, PUBKEY_CHUNK_BITS)
    bits = np.pad(bits, ((0, 0), (0, 0), (0, L * F.LIMB_BITS - PUBKEY_CHUNK_BITS)))
    weights = (1 << np.arange(F.LIMB_BITS, dtype=np.int32)).astype(np.int32)
    limbs = bits.reshape(len(moduli), PUBKEY_CHUNKS, L, F.LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(limbs.transpose(2, 1, 0))


def pubkey_hashes(moduli, device=None) -> torch.Tensor:
    """The circuit's pubkeyHash of every modulus, batched: the counterpart of
    ``[poseidon_large(n, 121, 9) for n in moduli]``, as (L, B) standard-form
    Fr limbs on `device` (``LB.limbs_to_ints`` gives the ints). One
    permutation at t = 10: 8 full rounds and 60 partial ones, 272 K1
    launches plus the two Montgomery conversions."""
    dev = resolve_device(device)
    chunks = LB.to_device(pubkey_chunks(moduli), dev)
    out = poseidon_torch(LB.to_mont(LB.FR_SPEC, chunks))
    return LB.from_mont(LB.FR_SPEC, out)
