"""The reference judges a tiny circuit's proofs, made by the program on the
CPU, correct, and a tampered proof or public incorrect; its verifying key
is the program's setup's."""

import random

import pytest
import torch

from proofbench import harness as H
from proofbench.circuits import header_digest
from proofbench.reference import bn254 as B
from proofbench.reference import judge as J
from proofbench.reference.poseidon import poseidon
from proofbench.signer import load_keys
from proofbench.traffic import Traffic, load_mix

SETUP_SEED = 5
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def proved():
    from zkemail_tpu_torch.prover.groth16 import prove_batch
    from zkemail_tpu_torch.prover.setup import groth16_setup

    keys = load_keys()
    t = Traffic(load_mix(H.HERE, "b1_short"), 77, keys)
    email = t.email(0)
    cc = header_digest.build({})
    w = cc.eval_witness(header_digest.host_inputs([email["raw"]], H._resolver(keys), {}, "cpu"),
                        1, device="cpu")
    pk = groth16_setup(cc, SETUP_SEED, device="cpu")
    (proof, publics), = prove_batch(pk, cc, w, rng=random.Random(1), device="cpu")
    return {"cc": cc, "pk": pk, "email": email, "answer": H._answer(proof, publics)}


def judge(p, answers, emails=None):
    out = J.judge(H.statement(p["cc"], SETUP_SEED), ["sha_hi", "sha_lo"],
                  emails or [p["email"]] * len(answers), answers, 9, ((1, 2), (1, 2)))
    out.pop("bad")
    return out


def test_poseidon_is_circomlibs():
    assert poseidon([1, 2]) == (
        7853200120776062878684798364095072458815029376092732009249414926327459813530)


def test_reference_verifying_key_is_the_setups(proved):
    pk, cc = proved["pk"], proved["cc"]
    tw = J.toxic_waste(SETUP_SEED)
    ks = J.public_scalars(H.statement(cc, SETUP_SEED))
    gamma_inv = pow(tw["gamma"], -1, B.R)
    for k, pt in zip(ks, pk.vk.ic):
        mine = B.G1_GEN.mul(k * gamma_inv)
        assert (mine.x, mine.y) == (pt.x, pt.y)


def test_sound_proofs_pass_and_tampering_fails(proved):
    ans = proved["answer"]
    zero = {"unanswered": 0, "publics_wrong": 0, "proofs_rejected": 0, "circuit_size_off": 0}
    assert judge(proved, [ans, ans]) == zero
    bumped = dict(ans, a=(lambda p: (p.x, p.y, False))(B.G1(*ans["a"][:2]).add(B.G1_GEN)))
    assert judge(proved, [ans, bumped])["proofs_rejected"] == 1
    wrong = dict(ans, publics=[ans["publics"][0] + 1, ans["publics"][1]])
    assert judge(proved, [wrong])["publics_wrong"] == 1
    other = Traffic(load_mix(H.HERE, "b1_short"), 78, load_keys()).email(0)
    got = judge(proved, [ans], emails=[other])  # the proof of another email
    assert got["publics_wrong"] == 1 and got["proofs_rejected"] == 1
    assert judge(proved, [None, ans])["unanswered"] == 1


def test_circuit_size_is_compared():
    out = J.judge({"setup_seed": 1, "n_constraints": 3, "n_public": 0,
                   "entries": {"A": [], "B": [], "C": []}}, [], [], [], 0,
                  ((3, 4, 2), (3, 5, 2)))
    assert out["circuit_size_off"] == 1
