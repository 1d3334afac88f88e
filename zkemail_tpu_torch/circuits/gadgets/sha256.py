"""SHA-256 as R1CS constraints + one vectorized witness step.

Parity target: zk-email-verify packages/circuits/lib/sha.circom —
Sha256Bytes:17, Sha256General:89 (variable length via output mux),
Sha256BytesPartial:47 / Sha256Partial:212 (midstate resume).

The constraint emission is the JAX package's (``zkemail_tpu/circuits/
gadgets/sha256.py``), numpy-vectorized over (blocks, bits). The witness is
ONE step per SHA instance that runs the whole 32-bit trace as torch int64
ops on the witness device (each word masked with ``& 0xFFFFFFFF``; torch's
uint32 lacks shifts on CUDA): the message schedule of every block at once,
then 64 rounds per block in sequence, batched over emails; the bits of every
allocated signal group are extracted at the end in one pass.

Constraint schema per block (~30k, vs. circom's ~29k):
  xor3 via 2 products/bit; Ch via 1 signed product/bit; Maj via 2; word
  additions mod 2^32 via 34/35/33-bit decompositions.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import field as F
from ..builder import LC, ConstraintSystem, SignalVec, lift_small
from .sha_constants import IV_WORDS, K_WORDS

L = F.LIMBS
P = F.R


def _word_lc(bits: SignalVec) -> LC:
    """(..., 32) little-endian bit signals -> word-valued LC."""
    acc = LC([], 0)
    for j in range(32):
        acc = acc + bits[..., j] * (1 << j)
    return acc


def _bits_lc(bits: SignalVec, n: int) -> LC:
    acc = LC([], 0)
    for j in range(n):
        acc = acc + bits[..., j] * (1 << j)
    return acc


class Sha256Instance:
    """Constraints + witness plan for n_blocks chained compressions."""

    def __init__(
        self,
        cs: ConstraintSystem,
        n_blocks: int,
        get_block_words,  # fn(env) -> (n_blocks, 16, B) uint32 message words
        midstate_words: SignalVec | None = None,  # (8,) word-valued signals, or None for IV
        get_midstate=None,  # fn(env) -> (8, B) uint32, required with midstate_words
    ):
        self.cs = cs
        self.nb = nb = n_blocks
        self.get_block_words = get_block_words
        self.get_midstate = get_midstate

        # ---------------- signal allocation (witness-plan order) ----------
        self.msg_bits = cs.alloc((nb, 16, 32), "sha_msg_bits")
        self.hin_bits = cs.alloc((nb, 8, 32), "sha_hin")
        self.sched_p = cs.alloc((nb, 48, 4, 32), "sha_sched_p")  # s0:p1,p2 s1:p1,p2
        self.sched_sum = cs.alloc((nb, 48, 34), "sha_sched_sum")
        self.sig1_p = cs.alloc((nb, 64, 2, 32), "sha_sig1_p")
        self.sig0_p = cs.alloc((nb, 64, 2, 32), "sha_sig0_p")
        self.ch_p = cs.alloc((nb, 64, 32), "sha_ch_p")  # signed {-1,0,1}
        self.maj_p = cs.alloc((nb, 64, 2, 32), "sha_maj_p")
        self.e_sum = cs.alloc((nb, 64, 35), "sha_e_sum")
        self.a_sum = cs.alloc((nb, 64, 35), "sha_a_sum")
        self.hout = cs.alloc((nb, 8, 33), "sha_hout")

        for sv in (self.msg_bits, self.sched_sum, self.e_sum, self.a_sum, self.hout, self.hin_bits):
            cs.enforce_bit(sv)
        # product signals are constrained by their defining equations; bits
        # among them are implied booleans (product of booleans), but Ch
        # products are ternary so we do not bit-constrain product groups.

        self._emit_hin_constraints(midstate_words)
        self._emit_schedule()
        self._emit_rounds()
        self._emit_hout()
        self._register_witness()

    # -------------------------------------------------------------- helpers
    def _w_all(self) -> SignalVec:
        """(nb, 64, 32) message-schedule bit signals (msg ∥ sched sums)."""
        return SignalVec(
            np.concatenate(
                [self.msg_bits.idx, self.sched_sum.idx[:, :, :32]], axis=1
            )
        )

    def _a_reg(self, r: int, k: int) -> SignalVec:
        """Register {a,b,c,d}[k] entering round r, as (nb, 32) bit signals."""
        i = r - 1 - k
        if i >= 0:
            return SignalVec(self.a_sum.idx[:, i, :32])
        return SignalVec(self.hin_bits.idx[:, k - r, :])

    def _e_reg(self, r: int, k: int) -> SignalVec:
        i = r - 1 - k
        if i >= 0:
            return SignalVec(self.e_sum.idx[:, i, :32])
        return SignalVec(self.hin_bits.idx[:, 4 + k - r, :])

    # ----------------------------------------------------------- constraints
    def _emit_hin_constraints(self, midstate_words):
        cs, nb = self.cs, self.nb
        # block 0: IV constants or provided midstate
        h0 = SignalVec(self.hin_bits.idx[:1, :, :])  # (1, 8, 32)
        if midstate_words is None:
            iv_bits = np.array(
                [[(IV_WORDS[wi] >> j) & 1 for j in range(32)] for wi in range(8)],
                dtype=object,
            )[None]
            cs.enforce_equal(h0.lc(), LC([], iv_bits))
        else:
            # midstate provided as 8 word signals: word == sum of hin bits
            for wi in range(8):
                cs.enforce_equal(
                    _word_lc(SignalVec(self.hin_bits.idx[0, wi, :])),
                    LC.of(midstate_words[wi]),
                )
        # block b>0: hin[b] == hout[b-1] low 32 bits
        if nb > 1:
            cs.enforce_equal(
                SignalVec(self.hin_bits.idx[1:, :, :]).lc(),
                SignalVec(self.hout.idx[:-1, :, :32]).lc(),
            )

    def _xor3(self, b1: SignalVec, b2: SignalVec, b3_idx, b3_mask, p1: SignalVec, p2: SignalVec) -> LC:
        """(b1 ^ b2 ^ mask*b3) with product signals p1, p2. b3 given as raw
        index array + 0/1 mask (for SHR-truncated bits)."""
        cs = self.cs
        cs.enforce(b1, b2, p1)
        x12 = b1 + b2.lc() - p1 * 2
        b3 = LC([(SignalVec(b3_idx), b3_mask)])
        cs.enforce(x12, b3, p2)
        return x12 + b3 - p2 * 2

    def _emit_schedule(self):
        cs, nb = self.cs, self.nb
        w = self._w_all()  # (nb, 64, 32)
        t = np.arange(16, 64)
        j = np.arange(32)

        def gather(offset):
            return SignalVec(w.idx[:, t - offset, :])  # (nb, 48, 32)

        wm15, wm2, wm16, wm7 = gather(15), gather(2), gather(16), gather(7)

        def rot(sv: SignalVec, r: int) -> SignalVec:
            return SignalVec(sv.idx[:, :, (j + r) % 32])

        def shr(sv: SignalVec, r: int):
            src = np.minimum(j + r, 31)
            mask = np.where(j + r < 32, 1, 0).astype(object)
            return sv.idx[:, :, src], np.broadcast_to(mask, (nb, 48, 32))

        s0_b3_idx, s0_mask = shr(wm15, 3)
        s0 = self._xor3(
            rot(wm15, 7), rot(wm15, 18), s0_b3_idx, s0_mask,
            SignalVec(self.sched_p.idx[:, :, 0, :]), SignalVec(self.sched_p.idx[:, :, 1, :]),
        )
        s1_b3_idx, s1_mask = shr(wm2, 10)
        s1 = self._xor3(
            rot(wm2, 17), rot(wm2, 19), s1_b3_idx, s1_mask,
            SignalVec(self.sched_p.idx[:, :, 2, :]), SignalVec(self.sched_p.idx[:, :, 3, :]),
        )
        # sum over bit-weighted words: w[t-16] + s0 + w[t-7] + s1 == sched_sum
        pow2 = np.array([1 << jj for jj in range(32)], dtype=object)
        sum_lc = (
            LC([(wm16, pow2), (wm7, pow2)])
            + _weight_lc(s0, pow2)
            + _weight_lc(s1, pow2)
        )
        total = _reduce_bits_axis(sum_lc)
        target = _reduce_bits_axis(_weight_lc(SignalVec(self.sched_sum.idx).lc(), np.array([1 << jj for jj in range(34)], dtype=object)))
        cs.enforce_equal(total, target)

    def _emit_rounds(self):
        cs, nb = self.cs, self.nb
        w = self._w_all()
        j = np.arange(32)
        pow2_32 = np.array([1 << jj for jj in range(32)], dtype=object)
        pow2_35 = np.array([1 << jj for jj in range(35)], dtype=object)
        for r in range(64):
            a, b_, c, d = (self._a_reg(r, k) for k in range(4))
            e, f, g, h = (self._e_reg(r, k) for k in range(4))

            def rot(sv: SignalVec, rr: int) -> SignalVec:
                return SignalVec(sv.idx[:, (j + rr) % 32])

            ones = np.ones((nb, 32), dtype=object)
            sig1 = self._xor3(
                rot(e, 6), rot(e, 11), rot(e, 25).idx, ones,
                SignalVec(self.sig1_p.idx[:, r, 0, :]), SignalVec(self.sig1_p.idx[:, r, 1, :]),
            )
            sig0 = self._xor3(
                rot(a, 2), rot(a, 13), rot(a, 22).idx, ones,
                SignalVec(self.sig0_p.idx[:, r, 0, :]), SignalVec(self.sig0_p.idx[:, r, 1, :]),
            )
            # ch = g + e*(f-g)
            chp = SignalVec(self.ch_p.idx[:, r, :])
            cs.enforce(e, f - g.lc(), chp)
            ch = g + chp.lc()
            # maj: mid = b*c ; m2 = a*(b + c - 2 mid); maj = m2 + mid
            mid = SignalVec(self.maj_p.idx[:, r, 0, :])
            m2 = SignalVec(self.maj_p.idx[:, r, 1, :])
            cs.enforce(b_, c, mid)
            cs.enforce(a, b_ + c.lc() - mid * 2, m2)
            maj = m2 + mid.lc()

            wr = SignalVec(w.idx[:, r, :])
            t1 = (
                _reduce_bits_axis(_weight_lc(h.lc(), pow2_32))
                + _reduce_bits_axis(_weight_lc(sig1, pow2_32))
                + _reduce_bits_axis(_weight_lc(ch, pow2_32))
                + _reduce_bits_axis(_weight_lc(wr.lc(), pow2_32))
                + int(K_WORDS[r])
            )
            t2 = _reduce_bits_axis(_weight_lc(sig0, pow2_32)) + _reduce_bits_axis(
                _weight_lc(maj, pow2_32)
            )
            d_word = _reduce_bits_axis(_weight_lc(d.lc(), pow2_32))
            e_target = _reduce_bits_axis(
                _weight_lc(SignalVec(self.e_sum.idx[:, r, :]).lc(), pow2_35)
            )
            cs.enforce_equal(d_word + t1, e_target)
            a_target = _reduce_bits_axis(
                _weight_lc(SignalVec(self.a_sum.idx[:, r, :]).lc(), pow2_35)
            )
            cs.enforce_equal(t1 + t2, a_target)

    def _emit_hout(self):
        cs = self.cs
        pow2_32 = np.array([1 << jj for jj in range(32)], dtype=object)
        pow2_33 = np.array([1 << jj for jj in range(33)], dtype=object)
        # final registers after round 64
        regs = [self._a_reg(64, k) for k in range(4)] + [self._e_reg(64, k) for k in range(4)]
        for wi in range(8):
            hin_w = _reduce_bits_axis(
                _weight_lc(SignalVec(self.hin_bits.idx[:, wi, :]).lc(), pow2_32)
            )
            fin_w = _reduce_bits_axis(_weight_lc(regs[wi].lc(), pow2_32))
            target = _reduce_bits_axis(
                _weight_lc(SignalVec(self.hout.idx[:, wi, :]).lc(), pow2_33)
            )
            cs.enforce_equal(hin_w + fin_w, target)

    # --------------------------------------------------------------- outputs
    def state_after(self, block: int) -> SignalVec:
        """(8, 32) bit signals of the state after `block` compressions
        (block in 1..nb)."""
        return SignalVec(self.hout.idx[block - 1, :, :32])

    def all_states(self) -> SignalVec:
        """(nb, 8, 32) per-block output-state bits."""
        return SignalVec(self.hout.idx[:, :, :32])

    # --------------------------------------------------------------- witness
    def _register_witness(self):
        cs, nb = self.cs, self.nb
        get_words = self.get_block_words
        get_mid = self.get_midstate
        groups = [
            self.msg_bits, self.hin_bits, self.sched_p, self.sched_sum,
            self.sig1_p, self.sig0_p, self.ch_p, self.maj_p,
            self.e_sum, self.a_sum, self.hout,
        ]
        out_idx = np.concatenate([g.idx.reshape(-1) for g in groups])
        sv_all = SignalVec(out_idx)

        iv = np.array(IV_WORDS, dtype=np.int64)[:, None]
        pm1 = np.array(F.to_limbs(P - 1), dtype=np.int32)[:, None, None]

        def step(env, iv=iv, pm1=pm1):
            words = get_words(env)  # (nb, 16, B) int64
            bsz = words.shape[-1]
            if get_mid is None:
                init = env.tensor(iv).expand(8, bsz)
            else:
                init = get_mid(env)  # (8, B)
            trace = _sha_trace(init, words)
            allv = torch.cat([trace[key].reshape(-1, bsz) for key in TRACE_KEYS])
            # values are bits, except ch_p in {-1, 0, 1}: -1 lifts to p - 1
            lifted = lift_small(allv.clamp(min=0))
            return torch.where((allv < 0).unsqueeze(0), env.tensor(pm1), lifted)

        cs.set_witness(sv_all, step, "sha256")


def _weight_lc(lc_or_sv, weights: np.ndarray) -> LC:
    """Multiply a bit-vector LC elementwise by per-bit weights (last axis)."""
    lc = LC.of(lc_or_sv) if not isinstance(lc_or_sv, LC) else lc_or_sv
    terms = [(sv, _mulw(c, weights)) for sv, c in lc.terms]
    const = _mulw(lc.const, weights) if _nz(lc.const) else 0
    return LC(terms, const)


def _mulw(c, w):
    if isinstance(c, np.ndarray):
        return c.astype(object) * w
    return np.asarray(w, dtype=object) * c


def _nz(c):
    if isinstance(c, np.ndarray):
        return True
    return c != 0


def _reduce_bits_axis(lc: LC) -> LC:
    """Sum an LC over its LAST axis: (…, nbits)-shaped terms -> (…,) terms.

    Implemented by splitting each term into per-bit terms (the builder emits
    one COO entry per term anyway, so this costs nothing extra).
    """
    terms = []
    const = 0
    for sv, c in lc.terms:
        nbits = sv.shape[-1]
        cf = np.broadcast_to(np.asarray(c, dtype=object), sv.shape)
        for jj in range(nbits):
            terms.append((sv[..., jj], cf[..., jj]))
    if isinstance(lc.const, np.ndarray):
        const = lc.const.sum(axis=-1)
    else:
        const = lc.const
    return LC(terms, const)


# ---------------------------------------------------------------------------
# 32-bit SHA trace (witness side), int64 tensors
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
# the signal groups in allocation order (Sha256Instance.__init__)
TRACE_KEYS = (
    "msg_bits", "hin", "sched_p", "sched_sum", "sig1_p", "sig0_p", "ch_p",
    "maj_p", "e_sum", "a_sum", "hout",
)


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & M32


def _bits_of(x: torch.Tensor, n: int) -> torch.Tensor:
    """(…, B) values below 2^n -> (…, n, B) bits, LSB first."""
    shifts = torch.arange(n, device=x.device).reshape(n, 1)
    return ((x.unsqueeze(-2) >> shifts) & 1).to(torch.int32)


def _sha_trace(init_state: torch.Tensor, words: torch.Tensor) -> dict:
    """Full SHA-256 trace. init_state (8, B) and words (nb, 16, B): int64
    tensors of 32-bit words. Returns the bits of every signal group, shaped
    as the groups plus a trailing batch axis.

    Sums are taken whole in int64 (at most five 32-bit words, below 2^35);
    a sum's low word and its carries are the JAX trace's chained add-with-
    overflow results."""
    nb = words.shape[0]
    # message schedule, every block at once: w (nb, B) per index t
    w = [words[:, t] for t in range(16)]
    sched_p, sched_sum = [], []
    for t in range(16, 64):
        wm15, wm2, wm16, wm7 = w[t - 15], w[t - 2], w[t - 16], w[t - 7]
        r7, r18, sh3 = _rotr(wm15, 7), _rotr(wm15, 18), wm15 >> 3
        r17, r19, sh10 = _rotr(wm2, 17), _rotr(wm2, 19), wm2 >> 10
        sched_p.append(torch.stack(
            [r7 & r18, (r7 ^ r18) & sh3, r17 & r19, (r17 ^ r19) & sh10], dim=1))
        total = wm16 + (r7 ^ r18 ^ sh3) + wm7 + (r17 ^ r19 ^ sh10)
        sched_sum.append(total)
        w.append(total & M32)
    w_all = torch.stack(w, dim=1)  # (nb, 64, B)

    out = {k: [] for k in ("hin", "sig1", "sig0", "chp", "chn", "maj", "es", "as", "ho")}
    state = init_state
    for blk in range(nb):
        a, b_, c, d, e, f, g, h = state.unbind(0)
        for r in range(64):
            r6, r11, r25 = _rotr(e, 6), _rotr(e, 11), _rotr(e, 25)
            r2, r13, r22 = _rotr(a, 2), _rotr(a, 13), _rotr(a, 22)
            ch = (e & f) ^ (~e & g)
            maj = (a & b_) ^ (a & c) ^ (b_ & c)
            t1 = h + (r6 ^ r11 ^ r25) + ch + int(K_WORDS[r]) + w_all[blk, r]
            es = d + t1
            as_ = t1 + (r2 ^ r13 ^ r22) + maj
            out["sig1"].append(torch.stack([r6 & r11, (r6 ^ r11) & r25]))
            out["sig0"].append(torch.stack([r2 & r13, (r2 ^ r13) & r22]))
            out["chp"].append(e & f)
            out["chn"].append(e & g)
            out["maj"].append(torch.stack([b_ & c, a & (b_ ^ c)]))
            out["es"].append(es)
            out["as"].append(as_)
            a, b_, c, d = as_ & M32, a, b_, c
            e, f, g, h = es & M32, e, f, g
        ho = state + torch.stack([a, b_, c, d, e, f, g, h])
        out["hin"].append(state)
        out["ho"].append(ho)
        state = ho & M32

    def rounds(key):  # (nb * 64, …) -> (nb, 64, …)
        v = torch.stack(out[key])
        return v.reshape((nb, 64) + tuple(v.shape[1:]))

    return {
        "msg_bits": _bits_of(words, 32),
        "hin": _bits_of(torch.stack(out["hin"]), 32),
        "sched_p": _bits_of(torch.stack(sched_p, dim=1), 32),
        "sched_sum": _bits_of(torch.stack(sched_sum, dim=1), 34),
        "sig1_p": _bits_of(rounds("sig1"), 32),
        "sig0_p": _bits_of(rounds("sig0"), 32),
        "ch_p": _bits_of(rounds("chp"), 32) - _bits_of(rounds("chn"), 32),
        "maj_p": _bits_of(rounds("maj"), 32),
        "e_sum": _bits_of(rounds("es"), 35),
        "a_sum": _bits_of(rounds("as"), 35),
        "hout": _bits_of(torch.stack(out["ho"]), 33),
    }
