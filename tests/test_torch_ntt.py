"""Port NTT (zkemail_tpu_torch.ops.ntt) against the JAX package at 2^8 on the
CPU: the constant tables and the transforms agree limb for limb. And the host
side of kernel K4 (ops/csrc/ntt_fr.cu), whose transform runs only on the
card: its pass split and its word tables against Python ints."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.core import field as JF
from zkemail_tpu.core import limbs as JL
from zkemail_tpu.ops import ntt as JN
from zkemail_tpu_torch.ops import field_kernels as FK
from zkemail_tpu_torch.ops import ntt as TN

torch.set_num_threads(1)

LOG_N = 8


def _mont_values(n, batch, seed):
    rng = np.random.default_rng(seed)
    vals = np.empty((n, batch), dtype=object)
    for idx in np.ndindex(n, batch):
        vals[idx] = int.from_bytes(rng.bytes(32), "little") % JL.FR_SPEC.p
    return JL.ints_to_limbs(vals)  # canonical limbs, read as Montgomery form


def test_domain_plan_equals_jax():
    ref = JN.domain_plan(LOG_N)
    plan = TN.domain_plan(LOG_N, "cpu")
    assert (plan["perm"].numpy() == ref["perm"]).all()
    for key in ("tw_fwd", "tw_inv"):
        assert len(plan[key]) == len(ref[key]) == LOG_N
        for ours, theirs in zip(plan[key], ref[key]):
            assert (ours.numpy() == theirs).all()
    assert (plan["ninv"].numpy() == ref["ninv"]).all()
    assert (plan["shift"].numpy() == ref["shift"]).all()
    assert (TN.coset_powers(5, True, "cpu").numpy() == JN._coset_powers(5, True)).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_equals_jax(inverse):
    x = _mont_values(1 << LOG_N, 2, 1)
    ref = np.asarray(JN.ntt(jnp.asarray(x), inverse=inverse))
    before = dict(FK.LAUNCHES)
    out = TN.ntt(torch.from_numpy(x), inverse=inverse, plan=TN.domain_plan(LOG_N, "cpu"))
    assert FK.LAUNCHES == before  # a CPU tensor runs the plain version
    assert (out.numpy() == ref).all()


def test_shifted_ntt_and_coset_roundtrip():
    x = _mont_values(1 << LOG_N, 1, 2)
    plan = TN.domain_plan(LOG_N, "cpu")
    ref = np.asarray(JN.shifted_ntt(jnp.asarray(x)))
    out = TN.shifted_ntt(torch.from_numpy(x), plan=plan)
    assert (out.numpy() == ref).all()
    tx = torch.from_numpy(x)
    assert (TN.coset_intt(TN.coset_ntt(tx, plan), plan) == tx).all()
    assert (TN.ntt(TN.ntt(tx, False, plan), True, plan) == tx).all()


def test_ntt_passes_cover_every_stage_once():
    """K4's passes: consecutive, at most PASS_STAGES stages each (the
    kernel's NTT_MAX_PASS), as few as that allows, the longer first."""
    cu = (Path(TN.__file__).parent / "csrc" / "ntt_fr.cu").read_text()
    assert int(re.search(r"NTT_MAX_PASS = (\d+);", cu).group(1)) == TN.PASS_STAGES
    for log_n in range(1, 29):
        passes = TN.ntt_passes(log_n)
        ks = [k for _, k in passes]
        assert [s0 for s0, _ in passes] == [sum(ks[:i]) for i in range(len(ks))]
        assert sum(ks) == log_n and len(ks) == -(-log_n // TN.PASS_STAGES)
        assert ks == sorted(ks, reverse=True) and max(ks) - min(ks) <= 1
    assert TN.ntt_passes(22) == [(0, 8), (8, 7), (15, 7)]
    assert TN.ntt_passes(8) == [(0, 8)]


def _word_ints(words: torch.Tensor) -> list:
    """(N, 8) int32 words -> the N integers they hold."""
    return [sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row))
            for row in words.tolist()]


def _r256(x: int) -> int:
    return x * (1 << 256) % JF.R


def test_kernel_plan_tables_at_2_4():
    """Every entry of K4's tables of a 2^4 domain: W^e * 2^256 for e < 8
    (W the 16th root and its inverse), sigma^i * 2^256 for i < 16 (sigma
    the 32nd root) and 1/16 * 2^256, mod r."""
    plan = TN.kernel_plan(4, "cpu")
    w, sigma, r = JF.fr_nth_root(4), JF.fr_nth_root(5), JF.R
    assert plan["log_n"] == 4
    assert _word_ints(plan["words_fwd"]) == [_r256(pow(w, e, r)) for e in range(8)]
    assert _word_ints(plan["words_inv"]) == [_r256(pow(w, -e, r)) for e in range(8)]
    assert _word_ints(plan["words_shift"]) == [_r256(pow(sigma, i, r)) for i in range(16)]
    assert _word_ints(plan["words_ninv"]) == [_r256(pow(16, -1, r))]
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in plan.values()
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("table", ["fwd", "inv", "shift"])
def test_power_words_at_2_22(table):
    """power_words, which builds K4's tables, at sampled exponents of the
    2^22 domain's tables (kernel_plan's bases), across both halves of its
    exponent split."""
    w = JF.fr_nth_root(22)
    base, count = {"fwd": (w, 1 << 21), "inv": (pow(w, -1, JF.R), 1 << 21),
                   "shift": (JF.fr_nth_root(23), 1 << 22)}[table]
    idx = [0, 1, 2, 2047, 2048, 2049, 123_456, (1 << 20) + 777, count - 2, count - 1]
    got = _word_ints(TN.power_words(base, torch.tensor(idx)))
    assert got == [_r256(pow(base, i, JF.R)) for i in idx]

