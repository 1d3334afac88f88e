"""The port's batched Poseidon (core/poseidon_torch.py) against the JAX
package on the CPU.

Inputs come from numpy seeds; every comparison is exact (limbs, ints or
affine points). poseidon_jax ran as tests/test_poseidon.py runs it (the
JAX CPU backend, where core.limbs never takes the Pallas kernel); its
outputs are frozen by tests/make_jax_reference.py."""

import random

import numpy as np
import pytest
import torch

import make_jax_reference as JR
from time_limit import time_limit  # noqa: F401  (autouse: each test under its limit)
from zkemail_tpu.core import field as JF
from zkemail_tpu.core import limbs as JLB
from zkemail_tpu.core.poseidon import permute, poseidon, poseidon_large
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core import poseidon_torch as PT

torch.set_num_threads(1)
B = 8


def _mont_inputs(n, seed):
    """(L, n, B) Montgomery limbs of seeded Fr values, and the values."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(32), "little") % JF.FR.p for _ in range(B)]
            for _ in range(n)]
    arr = np.stack([JLB.ints_to_limbs([JF.FR.to_mont(x) for x in row]) for row in vals], axis=1)
    return arr, vals


@pytest.mark.parametrize("n", [2, 9])  # t = 3 and t = 10
def test_poseidon_torch_equals_jax(n):
    arr, vals = _mont_inputs(n, 10 + n)
    got = PT.poseidon_torch(torch.from_numpy(arr))
    want = JR.read("poseidon_jax_b8")[0][f"n{n}"]
    assert got.shape == (JF.LIMBS, B)
    assert (got.numpy() == want).all()
    ints = LB.limbs_to_ints(got)
    assert [JF.FR.from_mont(int(v)) for v in ints] == [
        poseidon([vals[i][b] for i in range(n)]) for b in range(B)]


def test_permute_torch_equals_reference():
    arr, vals = _mont_inputs(3, 7)  # a whole t = 3 state, state[0] nonzero
    got = LB.limbs_to_ints(PT.permute_torch(torch.from_numpy(arr)))
    for b in range(B):
        want = permute([vals[i][b] for i in range(3)])
        assert [JF.FR.from_mont(int(v)) for v in got[:, b]] == want


def test_pubkey_hashes_equal_poseidon_large():
    rng = random.Random(8)
    moduli = [rng.getrandbits(2048) | (1 << 2047) | 1 for _ in range(6)]
    moduli += [1, (1 << 2178) + 5]  # bits past 2177 are dropped, as poseidon_large does
    got = LB.limbs_to_ints(PT.pubkey_hashes(moduli, device="cpu"))
    assert [int(v) for v in got] == [poseidon_large(m, 121, 9) for m in moduli]
