"""In-circuit Poseidon hash gadget (+ PoseidonLarge / PoseidonModular).

Parity targets: circomlib Poseidon as composed by
zk-email-verify packages/circuits/utils/hash.circom — PoseidonLarge:15
(17x121-bit limbs -> 9x242-bit merged chunks -> Poseidon(9)) and
PoseidonModular:49 (16-ary chunking with pairwise folding).

Constraint schema per instance: per round, per element: x2 = s*s,
x4 = x2*x2, x5 = x4*s products + an allocated post-mix state row (keeps LCs
from exploding through the linear layers).  The witness is ONE custom step
that runs the whole permutation trace in Montgomery limb math (a torch loop
over the rounds, K1 for every product), vectorized over instances and the
email batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import field as F
from ...core import limbs as LB
from ...core.poseidon import N_ROUNDS_F, N_ROUNDS_P, poseidon_params
from ..builder import LC, ConstraintSystem, SignalVec, reduce_sum

L = F.LIMBS
P = F.R


def poseidon_hash(cs: ConstraintSystem, inputs: SignalVec) -> SignalVec:
    """Poseidon over (m, n) input signals -> (m,) outputs (or (n,) -> ()).

    state = [0, inputs...]; output = state[0] after the permutation.
    """
    squeeze = inputs.idx.ndim == 1
    idx = inputs.idx[None, :] if squeeze else inputs.idx
    m, n = idx.shape
    t = n + 1
    consts, mds = poseidon_params(t)
    n_rounds = N_ROUNDS_F + N_ROUNDS_P[t - 2]
    half = N_ROUNDS_F // 2

    sbox = cs.alloc((m, n_rounds, t, 3), "pos_sbox")  # x2, x4, x5
    states = cs.alloc((m, n_rounds, t), "pos_state")  # post-mix state rows

    inputs_sv = SignalVec(idx)

    def pre_lc(r: int, i: int) -> LC:
        """State element i entering round r, plus the round constant."""
        c = consts[r * t + i]
        if r == 0:
            base = LC([], 0) if i == 0 else LC.of(SignalVec(idx[:, i - 1]))
        else:
            base = LC.of(SignalVec(states.idx[:, r - 1, i]))
        return base + c

    for r in range(n_rounds):
        is_full = r < half or r >= half + N_ROUNDS_P[t - 2]
        pres = [pre_lc(r, i) for i in range(t)]
        x2 = SignalVec(sbox.idx[:, r, :, 0])
        x4 = SignalVec(sbox.idx[:, r, :, 1])
        x5 = SignalVec(sbox.idx[:, r, :, 2])
        for i in range(t):
            cs.enforce(pres[i], pres[i], x2[:, i])
            cs.enforce(x2[:, i], x2[:, i], x4[:, i])
            cs.enforce(x4[:, i], pres[i], x5[:, i])
        # mixed output rows
        outs = []
        for i in range(t):
            if is_full:
                outs.append(LC.of(x5[:, i]))
            else:
                outs.append(LC.of(x5[:, i]) if i == 0 else pres[i])
        for i in range(t):
            acc = LC([], 0)
            for jj in range(t):
                acc = acc + outs[jj] * mds[i][jj]
            cs.enforce_equal(acc, SignalVec(states.idx[:, r, i]).lc())

    # ---- witness: full permutation trace ---------------------------------
    fs = LB.FR_SPEC
    c_np = np.array(
        [[F.to_limbs(F.FR.to_mont(consts[r * t + i])) for i in range(t)] for r in range(n_rounds)],
        dtype=np.int32,
    )  # (rounds, t, L)
    c_np = np.moveaxis(c_np, -1, 1)  # (rounds, L, t)
    m_np = np.array(
        [[F.to_limbs(F.FR.to_mont(mds[i][jj])) for jj in range(t)] for i in range(t)],
        dtype=np.int32,
    )
    m_np = np.moveaxis(m_np, -1, 0)  # (L, t, t)
    full_mask = np.array(
        [1 if (r < half or r >= half + N_ROUNDS_P[t - 2]) else 0 for r in range(n_rounds)],
        dtype=np.int32,
    )

    c_np = np.ascontiguousarray(c_np[:, :, None, :, None])  # (rounds, L, 1, t, 1)
    m_np = np.ascontiguousarray(m_np[:, None, :, :, None])  # (L, 1, t_out, t_in, 1)

    def step_fn(env, inputs_sv=inputs_sv, m=m, t=t):
        vals = env.fr(inputs_sv)  # (L, m, t - 1, B)
        bsz = vals.shape[-1]
        state = torch.cat(
            [torch.zeros((L, m, 1, bsz), dtype=torch.int32, device=vals.device),
             LB.to_mont(fs, vals)], dim=2)  # (L, m, t, B) Montgomery
        consts, mds = env.tensor(c_np), env.tensor(m_np)
        x2s, x4s, x5s, sts = [], [], [], []
        for r in range(n_rounds):
            pre = LB.add(fs, state, consts[r])
            x2 = LB.mont_mul(fs, pre, pre)
            x4 = LB.mont_mul(fs, x2, x2)
            x5 = LB.mont_mul(fs, x4, pre)
            if full_mask[r]:
                mix_in = x5
            else:
                mix_in = torch.cat([x5[:, :, :1], pre[:, :, 1:]], dim=2)
            prod = LB.mont_mul(fs, mds, mix_in.unsqueeze(2))  # (L, m, t_out, t_in, B)
            state = reduce_sum(prod, 3)
            x2s.append(x2)
            x4s.append(x4)
            x5s.append(x5)
            sts.append(state)
        # signal order: sbox (m, rounds, t, 3), then states (m, rounds, t)
        sbox_vals = torch.stack(
            [torch.stack(x2s, 2), torch.stack(x4s, 2), torch.stack(x5s, 2)], dim=-2
        )  # (L, m, rounds, t, 3, B)
        st_vals = torch.stack(sts, 2)  # (L, m, rounds, t, B)
        flat = torch.cat(
            [sbox_vals.reshape(L, -1, bsz), st_vals.reshape(L, -1, bsz)], dim=1
        )
        return LB.from_mont(fs, flat)

    all_idx = np.concatenate([sbox.idx.reshape(-1), states.idx.reshape(-1)])
    cs.set_witness(SignalVec(all_idx), step_fn, "poseidon")

    out = SignalVec(states.idx[:, n_rounds - 1, 0])
    return SignalVec(out.idx[0]) if squeeze else out


def poseidon_large(cs: ConstraintSystem, limbs: SignalVec, bits_per_limb: int = 121) -> SignalVec:
    """PoseidonLarge (hash.circom:15): merge 121-bit limb pairs into 242-bit
    chunks, hash with Poseidon(9). limbs: (17,) -> scalar output."""
    k = limbs.shape[0]
    n_chunks = (k + 1) // 2  # 9
    chunks = []
    for i in range(n_chunks):
        lo = limbs[2 * i]
        if 2 * i + 1 < k:
            chunk = lo + limbs[2 * i + 1] * (1 << bits_per_limb)
        else:
            chunk = LC.of(lo)
        chunks.append(cs.define(chunk, "pos_chunk"))
    merged = SignalVec(np.stack([c.idx for c in chunks]))
    return poseidon_hash(cs, merged)


def poseidon_modular(cs: ConstraintSystem, values: SignalVec) -> SignalVec:
    """PoseidonModular (hash.circom:49): 16-ary chunks folded pairwise."""
    n = values.shape[0]
    chunk_hashes = []
    for start in range(0, n, 16):
        chunk = values[start : min(start + 16, n)]
        chunk_hashes.append(poseidon_hash(cs, chunk))
    out = chunk_hashes[0]
    for h in chunk_hashes[1:]:
        pair = SignalVec(np.stack([out.idx, h.idx]))
        out = poseidon_hash(cs, pair)
    return out
