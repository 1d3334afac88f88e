"""The port's EmailVerifier against the JAX package's, on the CPU.

Header 448 / body 192 with the body-hash check, on two distinct emails
signed by the port's seeded signer plus two tampered copies (a flipped
signature bit, a changed body byte), one batch of B = 4: the compiled R1CS,
the ``prepare_inputs`` arrays and the witness (all four columns, limb for
limb) equal the JAX package's; the valid columns satisfy the R1CS and carry
the host's public values, the tampered ones do not satisfy it. Tolerance:
exact equality."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkemail_tpu.models.email_verifier import EmailVerifierConfig as JConfig
from zkemail_tpu.models.email_verifier import build_email_verifier as j_build
from zkemail_tpu.models.input_bridge import prepare_inputs as j_prepare
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon_large
from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig, build_email_verifier
from zkemail_tpu_torch.models.input_bridge import prepare_inputs

torch.set_num_threads(2)

HL, BL = 448, 192


def tampered(raw: dict, field: str, index: int, xor: int) -> dict:
    out = dict(raw)
    vals = [int(v) for v in raw[field]]
    vals[index] ^= xor
    out[field] = [str(v) for v in vals]
    return out


@pytest.fixture(scope="module")
def run():
    signer = LocalDKIMSigner(seed=3)
    emails = [
        signer.sign_email(subject="first email", body=b"The first body.\r\n"),
        signer.sign_email(subject="second", to="carol@example.net",
                          body=b"Another body,\r\nof two lines.\r\n"),
    ]
    args = InputGenArgs(max_headers_length=HL, max_body_length=BL)
    raws = [generate_email_verifier_inputs(e, signer.resolver(), args) for e in emails]
    batch = raws + [tampered(raws[0], "signature", 0, 1), tampered(raws[1], "emailBody", 3, 4)]
    jcfg = JConfig(max_headers_length=HL, max_body_length=BL)
    cfg = EmailVerifierConfig(max_headers_length=HL, max_body_length=BL)
    jcc = j_build(jcfg).cs.compile()
    handles = build_email_verifier(cfg)
    cc = handles.cs.compile()
    j_inputs = j_prepare(batch, jcfg)
    inputs = prepare_inputs(batch, cfg, device="cpu")
    jw = np.asarray(jcc.eval_witness(j_inputs, len(batch)))
    stats = {}
    w = cc.eval_witness(inputs, len(batch), device="cpu", stats=stats).numpy()
    return SimpleNamespace(signer=signer, emails=emails, jcc=jcc, cc=cc, handles=handles,
                           j_inputs=j_inputs, inputs=inputs, jw=jw, w=w, stats=stats)


def test_r1cs_identical(run):
    jcc, cc = run.jcc, run.cc
    assert (cc.n_constraints, cc.n_signals, cc.n_public) == (841_472, 815_329, 3)
    assert (jcc.n_constraints, jcc.n_signals, jcc.n_public) == (
        cc.n_constraints, cc.n_signals, cc.n_public)
    assert np.array_equal(jcc.perm, cc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(cc, m)):
            assert np.array_equal(x, y), m
    assert [s.name for s in jcc.steps] == [s.name for s in cc.steps]


def test_prepare_inputs_equal(run):
    assert set(run.inputs) == set(run.j_inputs)
    for name, x in run.inputs.items():
        assert x.device.type == "cpu" and x.dtype == torch.int32
        assert np.array_equal(x.numpy(), np.asarray(run.j_inputs[name])), name


def test_witness_equals_jax(run):
    assert run.w.shape == run.jw.shape == (22, run.cc.n_signals, 4)
    assert np.array_equal(run.w, run.jw)
    # the data-dependent branches cost host syncs, counted
    assert run.stats["syncs"] > 0 and run.stats["steps_s"]["is_zero.inv"] > 0


def test_publics_equal_host_values(run):
    n = run.signer.public_key[0]
    for b, eml in enumerate(run.emails):
        pub = [int(v) for v in LB.limbs_to_ints(run.w[:, 1:4, b])]
        digest = hashlib.sha256(verify_dkim_signature(eml, run.signer.resolver()).headers).digest()
        assert pub == [poseidon_large(n, 121, 9), int.from_bytes(digest[:16], "big"),
                       int.from_bytes(digest[16:], "big")]
        h = run.handles
        for sv, want in ((h.pubkey_hash, pub[0]), (h.sha_hi, pub[1]), (h.sha_lo, pub[2])):
            assert int(LB.limbs_to_ints(run.w[:, run.cc.perm[sv.idx], b])) == want


@pytest.mark.parametrize("column,ok", [(0, True), (1, True), (2, False), (3, False)],
                         ids=["email0", "email1", "tampered_signature", "tampered_body"])
def test_r1cs_satisfied_only_by_valid_emails(run, column, ok):
    assert run.cc.check_satisfied_host(LB.limbs_to_ints(run.w[:, :, column])) is ok
