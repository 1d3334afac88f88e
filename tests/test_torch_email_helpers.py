"""The port's application helper gadgets against the JAX package's, on the
CPU: ``gadgets/email_helpers.py`` (soft-line-break removal, email
nullifier, substring reveal), ``gadgets/clean_email.py`` (address
normalization and its host reference) and the EmailVerifier with
``remove_soft_line_breaks`` at header 448 / body 192.

Each gadget case builds one circuit by the same calls in both packages and
evaluates it on the same inputs, a batch of two made from a seed: one valid
column and one tampered column. The compiled R1CS must be identical, the
port's witness must equal the JAX ``eval_witness`` limb for limb, and the
valid column must satisfy the R1CS in both packages while the tampered one
does not (the cases of tests/test_email_helper_gadgets.py). Tolerance:
exact equality."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zkemail_tpu.circuits.builder as j_builder
import zkemail_tpu.circuits.gadgets.clean_email as j_clean
import zkemail_tpu.circuits.gadgets.email_helpers as j_helpers
import zkemail_tpu_torch.circuits.builder as t_builder
import zkemail_tpu_torch.circuits.gadgets.clean_email as t_clean
import zkemail_tpu_torch.circuits.gadgets.email_helpers as t_helpers
from zkemail_tpu.models.email_verifier import EmailVerifierConfig as JConfig
from zkemail_tpu.models.email_verifier import build_email_verifier as j_build
from zkemail_tpu.models.input_bridge import prepare_inputs as j_prepare
from zkemail_tpu_torch.core import limbs as LB
from zkemail_tpu_torch.core.poseidon import poseidon, poseidon_large
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig, build_email_verifier
from zkemail_tpu_torch.models.input_bridge import prepare_inputs

torch.set_num_threads(2)

JAX = types.SimpleNamespace(builder=j_builder, helpers=j_helpers, clean=j_clean)
PORT = types.SimpleNamespace(builder=t_builder, helpers=t_helpers, clean=t_clean)
B = 2


def assert_same_r1cs(jcc, tcc):
    assert (jcc.n_constraints, jcc.n_signals, jcc.n_public) == (
        tcc.n_constraints, tcc.n_signals, tcc.n_public)
    assert np.array_equal(jcc.perm, tcc.perm)
    for m in "ABC":
        for x, y in zip(getattr(jcc, m), getattr(tcc, m)):
            assert x.dtype == y.dtype and np.array_equal(x, y), m


def run_both(build, inputs: dict, fr_names=(), satisfied=(True, False)):
    """Build with both packages, compare the R1CS and the witnesses on
    `inputs` (numpy arrays with a trailing batch axis of B; fr_names hold
    Python ints, sent as limbs); column b satisfies the R1CS in both
    packages iff satisfied[b]. Returns (port circuit, handles, witness)."""
    built = {}
    for tag, ns in (("jax", JAX), ("port", PORT)):
        cs = ns.builder.ConstraintSystem("helper")
        handles = build(ns, cs)
        built[tag] = (cs.compile(), handles)
    jcc, tcc = built["jax"][0], built["port"][0]
    assert_same_r1cs(jcc, tcc)
    arrs = {k: LB.ints_to_limbs(v) if k in fr_names else np.asarray(v, np.int32)
            for k, v in inputs.items()}
    jw = np.asarray(jcc.eval_witness({k: jnp.asarray(v) for k, v in arrs.items()}, B))
    tw = tcc.eval_witness({k: torch.as_tensor(v) for k, v in arrs.items()}, B,
                          device="cpu").numpy()
    assert tw.dtype == np.int32 and np.array_equal(tw, jw)
    for b, want in enumerate(satisfied):
        ints = [int(v) for v in LB.limbs_to_ints(tw[:, :, b])]
        assert tcc.check_satisfied_host(ints) is want
        assert bool(jcc.check_satisfied_host(ints)) is want
    return tcc, built["port"][1], tw


def values(cc, w, sv, b):
    return [int(v) for v in LB.limbs_to_ints(w[:, cc.perm[np.asarray(sv.idx).reshape(-1)], b])]


def padded(data: bytes, n: int) -> np.ndarray:
    return np.frombuffer(data.ljust(n, b"\x00"), dtype=np.uint8).astype(np.int64)


def test_remove_soft_line_breaks():
    n = 24
    enc = padded(b"hello=\r\nworld=\r\n!!", n)
    dec = padded(b"helloworld!!", n)
    bad = dec.copy()
    bad[0] ^= 1

    def build(ns, cs):
        e = cs.add_input("enc", (n,))
        d = cs.add_input("dec", (n,))
        return ns.helpers.remove_soft_line_breaks(cs, e, d)

    run_both(build, {"enc": np.stack([enc, enc], 1), "dec": np.stack([dec, bad], 1)})


def test_email_nullifier():
    rng = np.random.default_rng(21)
    sigs = [int.from_bytes(rng.bytes(256), "big") for _ in range(B)]
    limbs = np.array([[(s >> (121 * i)) & ((1 << 121) - 1) for s in sigs] for i in range(17)],
                     dtype=object)

    def build(ns, cs):
        s = cs.add_input("sig", (17,), dtype="fr")
        return ns.helpers.email_nullifier(cs, s)

    cc, out, w = run_both(build, {"sig": limbs}, fr_names={"sig"}, satisfied=(True, True))
    for b, sig in enumerate(sigs):
        assert values(cc, w, out, b) == [poseidon([poseidon_large(sig, 121, 9)])]


@pytest.mark.parametrize("unique", [False, True])
def test_reveal_substring(unique):
    """Column 0 reveals "NEEDLE"; column 1's window runs past the text's end
    (start + length > n), which the bounds checks refuse. The revealed
    window is zero-padded to its 8 bytes, so for the uniqueness check the
    needle ends the text, and "NEEDLE\0\0" occurs once."""
    n = 24
    text = padded(b"find the NEEDLE" if unique else b"find the NEEDLE here....", n)

    def build(ns, cs):
        t = cs.add_input("text", (n,))
        st = cs.add_input("start", ())
        ln = cs.add_input("len", ())
        return ns.helpers.reveal_substring(cs, t, st, ln, 8, enforce_uniqueness=unique)

    cc, sub, w = run_both(build, {"text": np.stack([text, text], 1),
                                  "start": np.array([9, 20]), "len": np.array([6, 6])})
    assert bytes(values(cc, w, sub, 0)) == b"NEEDLE\x00\x00"


def test_clean_email_address():
    n = 32
    addresses = [b"first.last+tag@gmail.com", b"a.b.c@x.org", b"plain@host", b"no-at.sign+x",
                 b"+only@tag.com", b"", b"dots.after@the.at.sign"]
    for a in addresses:
        pad = a.ljust(n, b"\x00")
        assert t_clean.clean_email_host(pad) == j_clean.clean_email_host(pad)
    enc = padded(addresses[0], n)
    dec = np.frombuffer(t_clean.clean_email_host(bytes(enc.astype(np.uint8))),
                        dtype=np.uint8).astype(np.int64)
    assert bytes(dec.astype(np.uint8)).rstrip(b"\x00") == b"firstlast@gmail.com"
    bad = dec.copy()
    bad[0] ^= 2

    def build(ns, cs):
        e = cs.add_input("enc", (n,))
        d = cs.add_input("dec", (n,))
        return ns.clean.clean_email_address(cs, e, d)

    run_both(build, {"enc": np.stack([enc, enc], 1), "dec": np.stack([dec, bad], 1)})


# ---------------------------------------------------------------------------
# the EmailVerifier's remove_soft_line_breaks flag
# ---------------------------------------------------------------------------

HL, BL = 448, 192
SOFT_BODY = (b"A quoted-printable body whose long line is soft=\r\n"
             b"broken twice, here=\r\nand here.\r\n")


def test_email_verifier_soft_line_breaks():
    """At 448/192 with the flag on: the JAX package's R1CS, inputs and
    witness; decodedEmailBodyIn carries the body without its '=\\r\\n'
    breaks and is public after the three standard outputs; a decoded body
    that keeps a break leaves that column unsatisfied."""
    signer = LocalDKIMSigner(seed=9)
    eml = signer.sign_email(subject="soft breaks", body=SOFT_BODY)
    args = InputGenArgs(max_headers_length=HL, max_body_length=BL, remove_soft_line_breaks=True)
    raw = generate_email_verifier_inputs(eml, signer.resolver(), args)
    body = bytes(int(v) for v in raw["emailBody"])
    decoded = bytes(int(v) for v in raw["decodedEmailBodyIn"])
    assert body.count(b"=\r\n") == 2 and b"=\r\n" not in decoded
    assert decoded.rstrip(b"\x00") == body.rstrip(b"\x00").replace(b"=\r\n", b"")
    bad = dict(raw)
    bad["decodedEmailBodyIn"] = [str(b) for b in body]  # the breaks kept

    jcfg = JConfig(max_headers_length=HL, max_body_length=BL, remove_soft_line_breaks=True)
    cfg = EmailVerifierConfig(max_headers_length=HL, max_body_length=BL,
                              remove_soft_line_breaks=True)
    jcc = j_build(jcfg).cs.compile()
    cc = build_email_verifier(cfg).cs.compile()
    assert_same_r1cs(jcc, cc)
    assert cc.n_public == 3 + BL

    j_inputs = j_prepare([raw, bad], jcfg)
    inputs = prepare_inputs([raw, bad], cfg, device="cpu")
    assert set(inputs) == set(j_inputs) and "decodedEmailBodyIn" in inputs
    for k in inputs:
        assert np.array_equal(inputs[k].numpy(), np.asarray(j_inputs[k])), k
    jw = np.asarray(jcc.eval_witness(j_inputs, 2))
    w = cc.eval_witness(inputs, 2, device="cpu").numpy()
    assert np.array_equal(w, jw)
    publics = [int(v) for v in LB.limbs_to_ints(w[:, 1 : cc.n_public + 1, 0])]
    assert publics[0] == poseidon_large(signer.public_key[0], 121, 9)
    assert bytes(publics[3:]) == decoded
    for b, want in enumerate((True, False)):
        assert cc.check_satisfied_host(LB.limbs_to_ints(w[:, :, b])) is want
