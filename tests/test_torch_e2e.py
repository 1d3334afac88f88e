"""The port's Groth16 slice on its own, on the CPU: port setup -> prove ->
verify on the bits circuit (compiled by the JAX package's builder and
carried across as arrays) and on a synthetic R1CS of a 2^8 domain
(zkemail_tpu_torch/scripts/synthetic_r1cs.py); and the entry points refuse
to run without device="cpu" when there is no CUDA device."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkemail_tpu.circuits.builder import ConstraintSystem
from zkemail_tpu.circuits.gadgets import basic as B
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.prover.containers import verify
from zkemail_tpu_torch.prover.convert import proving_key_from_arrays, r1cs_from_arrays
from zkemail_tpu_torch.prover.groth16 import prove, prove_batch
from zkemail_tpu_torch.prover.setup import groth16_setup
from zkemail_tpu_torch.scripts.synthetic_r1cs import make_circuit

torch.set_num_threads(1)


def test_bits_circuit_setup_prove_verify():
    cs = ConstraintSystem("bits")
    x = cs.add_input("x", ())
    B.num2bits(cs, x, 16)
    lt = B.less_than(cs, x, 1000, 16)
    cs.mark_public(lt)
    jcc = cs.compile()
    w = np.asarray(jcc.eval_witness({"x": jnp.asarray([999], dtype=jnp.int32)}, 1))
    cc = r1cs_from_arrays(name=jcc.name, A=jcc.A, B=jcc.B, C=jcc.C,
                          n_constraints=jcc.n_constraints, n_signals=jcc.n_signals,
                          n_public=jcc.n_public)
    pk = groth16_setup(cc, seed=7, device="cpu")
    proof, publics = prove(pk, cc, w[:, :, 0], rng=random.Random(3), device="cpu")
    assert publics == [1]
    assert verify(pk.vk, proof, publics)
    assert not verify(pk.vk, proof, [0])


def test_synthetic_circuit_shape():
    circ = make_circuit(240, 220, seed=1)
    cc = circ.r1cs
    assert (cc.n_constraints, cc.n_signals, cc.n_public) == (240, 220, 3)
    w = circ.witness(2, seed=3)
    assert w.shape == (22, 220, 2)
    for b in range(2):
        assert cc.check_satisfied_host(LB.limbs_to_ints(w[:, :, b]))
    small = (w[1:] == 0).all(axis=(0, 2)).sum()  # signals below 2^12
    assert small >= 0.95 * cc.n_signals
    bad = w.copy()
    bad[0, circ.bits[0], 0] = 2  # not a bit
    assert not cc.check_satisfied_host(LB.limbs_to_ints(bad[:, :, 0]))


def test_synthetic_setup_prove_batch_verify():
    circ = make_circuit(240, 220, seed=1)
    cc = circ.r1cs
    pk = groth16_setup(cc, seed=5, device="cpu")
    assert pk.domain_log2 == 8
    timers = {}
    proofs = prove_batch(pk, cc, circ.witness(2, seed=3), rng=random.Random(1),
                         timers=timers, device="cpu")
    assert set(timers) == {"h_stage_s", "msm_h_s", "msm_a_s", "msm_b2_s",
                           "msm_b1_s", "msm_c_s", "plan"}
    for proof, publics in proofs:
        assert len(publics) == 3
        assert verify(pk.vk, proof, publics)
        assert not verify(pk.vk, proof, [publics[0] + 1] + publics[1:])


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    circ = make_circuit(240, 220, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        groth16_setup(circ.r1cs, seed=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prove_batch(None, circ.r1cs, circ.witness(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prove(None, circ.r1cs, circ.witness(1)[:, :, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        proving_key_from_arrays(domain_log2=8, n_public=3, n_constraints=240,
                                queries={}, points={}, ic=[])
