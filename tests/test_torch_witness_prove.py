"""A toy circuit from the port's own builder, proved end to end on the CPU:
gadgets (bit decomposition, a comparator, a product, a Poseidon hash), the
port's witness at B = 2 (both columns satisfy the R1CS, a changed input
limb does not), then ``groth16_setup`` and ``prove_batch`` on the compiled
circuit itself. The proof verifies under the pairing oracle, a tampered
public is refused, and the public outputs are the host's values. The prove
takes one witness: on the CPU each batch column costs about a minute of
plain K2/K3 additions at this size."""

import random

import numpy as np
import torch

from zkemail_tpu_torch.circuits.builder import ConstraintSystem
from zkemail_tpu_torch.circuits.gadgets import basic
from zkemail_tpu_torch.circuits.gadgets.poseidon_gadget import poseidon_hash
from zkemail_tpu_torch.circuits.r1cs import satisfied
from zkemail_tpu_torch.core import field as F
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon
from zkemail_tpu_torch.prover.containers import verify
from zkemail_tpu_torch.prover.groth16 import prove_batch
from zkemail_tpu_torch.prover.setup import groth16_setup

torch.set_num_threads(2)


def test_toy_circuit_witness_setup_prove_verify():
    cs = ConstraintSystem("toy")
    x = cs.add_input("x", (2,))
    basic.num2bits(cs, x, 12)
    lt = basic.less_than(cs, x[0], x[1], 12)
    prod = cs.mul(x[0], x[1])
    h = poseidon_hash(cs, prod.reshape(1))
    cs.mark_public(h)
    cs.mark_public(lt)
    cc = cs.compile()
    xs = np.array([[5, 3000], [77, 12]], dtype=np.int32)  # (2 inputs, B = 2)
    w = cc.eval_witness({"x": torch.as_tensor(xs)}, 2, device="cpu")
    assert satisfied(cc, w).tolist() == [True, True]

    pk = groth16_setup(cc, seed=9, device="cpu")
    (proof, publics), = prove_batch(pk, cc, w[:, :, :1], rng=random.Random(2), device="cpu")
    a, c = int(xs[0, 0]), int(xs[1, 0])
    assert publics == [poseidon([a * c]), int(a < c)]
    assert verify(pk.vk, proof, publics)
    assert not verify(pk.vk, proof, [(publics[0] + 1) % F.R, publics[1]])

    bad = w.clone()
    bad[:, 1 + cc.n_public, 0] = LB.to_device(LB.ints_to_limbs([2]), "cpu")[:, 0]
    assert satisfied(cc, bad).tolist() == [False, True]
