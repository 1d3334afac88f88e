"""In-circuit DFA matching with reveal arrays (the zk-regex role).

Arithmetization (vectorized over positions):
  * per-position one-hot state vectors (maxLen+1, S) with a single custom
    witness step running the DFA scan (a torch loop over the positions,
    each a gather from the dense table);
  * byteset indicator signals shared across states (deduped by byteset,
    built from range comparators);
  * one product per (state, byteset) transition; next-state rows are linear;
  * reveal[i] = byte[i] * (sum of tag-marked active transitions at i);
  * is_match = any accepting state reached.

Parity contract: match flag + reveal array zeroed outside the match — the
interface EmailVerifier consumes from zk-regex's BodyHashRegex
(email-verifier.circom:124-131).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import field as F
from ..builder import LC, ConstraintSystem, SignalVec, lift_small
from ..regex_compiler import DFA
from .basic import is_equal, is_zero, less_than, num2bits

L = F.LIMBS


def _byteset_ranges(byteset: frozenset) -> list[tuple[int, int]]:
    ranges = []
    bs = sorted(byteset)
    start = prev = bs[0]
    for b in bs[1:]:
        if b == prev + 1:
            prev = b
        else:
            ranges.append((start, prev))
            start = prev = b
    ranges.append((start, prev))
    return ranges


def dfa_match_gadget(
    cs: ConstraintSystem,
    data: SignalVec,  # (maxLen,) byte signals
    dfa: DFA,
    n_reveal_groups: int = 1,
    reveal_tags: list[int] | None = None,
    initial_state: int | None = None,
    bytes_checked: bool = False,
):
    """Returns (is_match, reveal) where reveal is (n_reveal_groups, maxLen)
    signals equal to data[i] on tag-marked consumed bytes and 0 elsewhere.

    reveal_tags maps reveal rows to capture-group tags (default 0..n-1).
    initial_state overrides dfa.start — e.g. the state after consuming a
    virtual "\\r\\n" prefix, which realizes zk-regex's `(\\r\\n|^)` line anchor
    without materializing extra signals (the prefix bytes are constants).
    bytes_checked: pass True when `data` is already range-checked to 8 bits
    elsewhere (e.g. by sha256_bytes); False adds the checks here."""
    n = data.shape[0]
    S = dfa.n_states
    if not bytes_checked:
        num2bits(cs, data, 8)
    start_state = dfa.start if initial_state is None else initial_state
    if reveal_tags is None:
        reveal_tags = list(range(n_reveal_groups))

    # ---- group transitions: (state, target, tag) -> byteset ---------------
    trans: dict[tuple[int, int, int], set] = {}
    for s in range(S):
        for b in range(256):
            t = dfa.next_state[s][b]
            tag = dfa.reveal_tag[s][b]
            trans.setdefault((s, t, tag), set()).add(b)
    trans = {k: frozenset(v) for k, v in trans.items()}

    # ---- shared byteset indicators ---------------------------------------
    # One threshold signal t_c = (byte < c) per DISTINCT range boundary,
    # shared across all bytesets; a range [lo, hi] is then the LINEAR
    # combination t_{hi+1} - t_{lo}, and a byteset is the sum of its ranges.
    # Single-byte ranges use one shared is_equal. This cuts per-position
    # indicator cost ~5x vs per-range comparator pairs + products.
    # NOTE: threshold/equality semantics assume byte values < 256 — callers
    # must range-check `data` to 8 bits (sha256_bytes does; standalone users
    # pass bytes_checked=False to get checks here).
    full = frozenset(range(256))
    uniq_sets = {bs for (_, _, _), bs in trans.items() if bs != full}
    thresholds: dict[int, SignalVec] = {}
    equalities: dict[int, SignalVec] = {}

    def thr(c: int) -> LC:
        """(byte < c) as an LC; degenerate bounds fold to constants."""
        if c <= 0:
            return LC([], 0)
        if c >= 256:
            return LC([], 1)
        if c not in thresholds:
            thresholds[c] = less_than(cs, data, LC([], c), 9)
        return LC.of(thresholds[c])

    def eq_ind(c: int) -> LC:
        if c not in equalities:
            equalities[c] = is_equal(cs, data, LC([], c))
        return LC.of(equalities[c])

    indicators: dict[frozenset, LC | None] = {full: None}
    for bs in uniq_sets:
        acc = LC([], 0)
        for lo, hi in _byteset_ranges(bs):
            if lo == hi:
                acc = acc + eq_ind(lo)
            else:
                acc = acc + thr(hi + 1) - thr(lo)
        indicators[bs] = acc

    # ---- state one-hots ----------------------------------------------------
    onehot = cs.alloc((n + 1, S), "dfa_state")

    # ---- witness for the state one-hots (single DFA scan) -----------------
    table = np.array(dfa.next_state, dtype=np.int64)  # (S, 256)
    states_col = np.arange(S, dtype=np.int64).reshape(1, S, 1)

    def step(env, data=data, n=n):
        bytes_v = env.u32(data)  # (n, B)
        nxt = env.tensor(table)[:, bytes_v]  # (S, n, B): the next state per byte
        state = torch.full((1, bytes_v.shape[-1]), start_state, dtype=torch.int64,
                           device=bytes_v.device)
        all_states = [state]
        for i in range(n):
            state = nxt[:, i].gather(0, state)
            all_states.append(state)
        all_states = torch.cat(all_states)  # (n + 1, B)
        oh = (all_states.unsqueeze(1) == env.tensor(states_col)).to(torch.int32)
        return lift_small(oh.reshape(-1, oh.shape[-1]))

    cs.set_witness(onehot, step, "dfa_states")
    # One-hot-ness needs NO bit/row-sum constraints: row 0 is constant
    # one-hot (below), and since the DFA's transition function PARTITIONS the
    # byte alphabet per state, the per-position byteset indicators of one
    # state sum to exactly 1 for any byte in [0, 256). By induction each
    # next-state row (linear in products of a one-hot row with a partition
    # of indicators) is again one-hot. Same argument as zk-regex-circom.
    init = np.zeros(S, dtype=object)
    init[start_state] = 1
    cs.enforce_equal(SignalVec(onehot.idx[0]).lc(), LC([], init))

    # ---- transition products + next-state rows ----------------------------
    # trans_active[(s,t,tag)] (n,) = onehot[i, s] * ind(byte_i in B)
    active: dict[tuple[int, int, int], object] = {}
    for (s, t, tag), bs in trans.items():
        cur = SignalVec(onehot.idx[:n, s])
        ind = indicators[bs]
        if ind is None:
            active[(s, t, tag)] = LC.of(cur)
        else:
            active[(s, t, tag)] = LC.of(cs.mul(cur, ind, "dfa_act"))
    for t in range(S):
        acc = LC([], 0)
        found = False
        for (s, tt, tag), a in active.items():
            if tt == t:
                acc = acc + a
                found = True
        nxt = SignalVec(onehot.idx[1:, t])
        cs.enforce_equal(acc if found else LC([], 0), nxt.lc())

    # ---- reveal arrays ----------------------------------------------------
    reveals = []
    for g in reveal_tags:
        tag_sum = LC([], 0)
        any_tag = False
        for (s, t, tag), a in active.items():
            if tag == g:
                tag_sum = tag_sum + a
                any_tag = True
        if any_tag:
            reveals.append(cs.mul(tag_sum, data, "dfa_reveal"))
        else:
            z = cs.define(LC([], np.zeros(n, dtype=object)), "dfa_reveal0")
            reveals.append(z)
    reveal = SignalVec(np.stack([r.idx for r in reveals]))

    # ---- match flag --------------------------------------------------------
    acc_total = LC([], 0)
    for i in range(1, n + 1):
        for s in dfa.accepting:
            acc_total = acc_total + SignalVec(onehot.idx[i, s])
    nz = is_zero(cs, acc_total)
    is_match = cs.define(1 - nz.lc(), "dfa_match")
    return is_match, reveal
