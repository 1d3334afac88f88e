"""The port's EmailVerifier flags against the JAX package's, on the CPU.

One case each at B = 1, header 448 / body 192: ``ignore_body_hash_check``
(no body inputs), and header plus body masking with the body check on. For
each, the compiled R1CS and the witness equal the JAX package's exactly,
the witness satisfies the R1CS, and the masked outputs are the masked bytes.
``remove_soft_line_breaks`` builds the JAX circuit (its witness is checked
in tests/test_torch_email_helpers.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkemail_tpu.models.email_verifier import EmailVerifierConfig as JConfig
from zkemail_tpu.models.email_verifier import build_email_verifier as j_build
from zkemail_tpu.models.input_bridge import prepare_inputs as j_prepare
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig, build_email_verifier
from zkemail_tpu_torch.models.input_bridge import prepare_inputs

torch.set_num_threads(2)

HL, BL = 448, 192


@pytest.fixture(scope="module")
def signer():
    return LocalDKIMSigner(seed=5)


def run_case(signer, flags: dict, args: InputGenArgs):
    eml = signer.sign_email(subject="flags", body=b"Masked body bytes.\r\n")
    raw = generate_email_verifier_inputs(eml, signer.resolver(), args)
    jcfg = JConfig(max_headers_length=HL, max_body_length=BL, **flags)
    cfg = EmailVerifierConfig(max_headers_length=HL, max_body_length=BL, **flags)
    jcc = j_build(jcfg).cs.compile()
    handles = build_email_verifier(cfg)
    cc = handles.cs.compile()
    assert (jcc.n_constraints, jcc.n_signals, jcc.n_public) == (
        cc.n_constraints, cc.n_signals, cc.n_public)
    assert np.array_equal(jcc.perm, cc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(cc, m)):
            assert np.array_equal(x, y), m
    j_inputs = j_prepare([raw], jcfg)
    inputs = prepare_inputs([raw], cfg, device="cpu")
    assert set(inputs) == set(j_inputs)
    jw = np.asarray(jcc.eval_witness({k: jnp.asarray(v) for k, v in j_inputs.items()}, 1))
    w = cc.eval_witness(inputs, 1, device="cpu").numpy()
    assert np.array_equal(w, jw)
    assert cc.check_satisfied_host(LB.limbs_to_ints(w[:, :, 0]))
    return raw, handles, cc, w


def masked(cc, w, sv):
    return [int(v) for v in LB.limbs_to_ints(w[:, cc.perm[sv.idx], 0])]


def test_ignore_body_hash_check(signer):
    args = InputGenArgs(ignore_body_hash_check=True, max_headers_length=HL,
                        max_body_length=BL)
    raw, handles, cc, _ = run_case(signer, {"ignore_body_hash_check": True}, args)
    assert "emailBody" not in raw and handles.body_digest_bits is None
    assert cc.n_public == 3


def test_header_and_body_masking(signer):
    header_mask = [i % 3 == 0 for i in range(HL)]
    body_mask = [i % 2 == 1 for i in range(BL)]
    args = InputGenArgs(max_headers_length=HL, max_body_length=BL,
                        enable_header_masking=True, header_mask=header_mask,
                        enable_body_masking=True, body_mask=body_mask)
    raw, handles, cc, w = run_case(
        signer, {"enable_header_masking": True, "enable_body_masking": True}, args)
    assert cc.n_public == 3 + HL + BL
    header = [int(v) for v in raw["emailHeader"]]
    body = [int(v) for v in raw["emailBody"]]
    assert masked(cc, w, handles.masked_header) == [b * m for b, m in zip(header, header_mask)]
    assert masked(cc, w, handles.masked_body) == [b * m for b, m in zip(body, body_mask)]


def test_soft_line_breaks_not_ported():
    """The flag is ported now (its witness is held to the JAX package's in
    tests/test_torch_email_helpers.py): it builds the JAX circuit, with
    decodedEmailBodyIn as an input and public after the three outputs."""
    handles = build_email_verifier(EmailVerifierConfig(
        max_headers_length=HL, max_body_length=BL, remove_soft_line_breaks=True))
    cc = handles.cs.compile()
    jcc = j_build(JConfig(max_headers_length=HL, max_body_length=BL,
                          remove_soft_line_breaks=True)).cs.compile()
    assert (cc.n_constraints, cc.n_signals, cc.n_public) == (
        jcc.n_constraints, jcc.n_signals, jcc.n_public)
    assert cc.n_public == 3 + BL
    decoded = next(b for b in cc.input_bindings if b.name == "decodedEmailBodyIn")
    assert list(cc.perm[decoded.signals.idx]) == list(range(4, 4 + BL))
