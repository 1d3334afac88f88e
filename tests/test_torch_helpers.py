"""The port's host pipeline against the JAX package's: SHA utilities,
canonicalization, binary formats, DKIM verification, circuit-input
generation and the seeded signer (no ``cryptography`` in the port; the test
uses it to hold the port's key encoding and signatures to a library).
Tolerance: exact equality."""

import base64
import hashlib

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import padding
from cryptography.hazmat.primitives.serialization import load_der_public_key

from zkemail_tpu.helpers import binary_format as j_bf
from zkemail_tpu.helpers import canon as j_canon
from zkemail_tpu.helpers import sha_utils as j_sha
from zkemail_tpu.helpers.dkim import verify_dkim_signature as j_verify
from zkemail_tpu.helpers.dns import parse_dkim_txt as j_parse_txt
from zkemail_tpu.helpers.input_gen import InputGenArgs as JArgs
from zkemail_tpu.helpers.input_gen import generate_email_verifier_inputs as j_inputs
from zkemail_tpu.helpers.testkit import LocalDKIMSigner as JSigner
from zkemail_tpu_torch.helpers import binary_format as t_bf
from zkemail_tpu_torch.helpers import canon as t_canon
from zkemail_tpu_torch.helpers import sha_utils as t_sha
from zkemail_tpu_torch.helpers.dkim import DKIMError
from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature as t_verify
from zkemail_tpu_torch.helpers.dns import parse_dkim_txt as t_parse_txt
from zkemail_tpu_torch.helpers.input_gen import InputGenArgs as TArgs
from zkemail_tpu_torch.helpers.input_gen import generate_email_verifier_inputs as t_inputs
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner as TSigner

BODY = b"Hello,\r\n\r\nA  body   with  spaces \t\r\nand lines.\r\n\r\n\r\n"


@pytest.fixture(scope="module")
def port_signer():
    return TSigner(seed=7)


def test_sha_utils_match():
    rng = np.random.default_rng(1)
    for n in (0, 1, 55, 56, 63, 64, 119, 200, 1000):
        data = rng.bytes(n)
        assert t_sha.sha256(data) == j_sha.sha256(data) == hashlib.sha256(data).digest()
        assert t_sha.sha256_pad(data, 1152) == j_sha.sha256_pad(data, 1152)
        assert t_sha.partial_sha(data[: n - n % 64]) == j_sha.partial_sha(data[: n - n % 64])
    text = b"x" * 130 + b"needle" + b"y" * 164
    padded, plen = j_sha.sha256_pad(text, 512)
    for sel in (None, "needle"):
        want = j_sha.generate_partial_sha(padded, plen, sel, 448)
        assert t_sha.generate_partial_sha(padded, plen, sel, 448) == want
    for sel, max_len in (("absent", 448), (None, 64)):
        with pytest.raises(ValueError):
            j_sha.generate_partial_sha(padded, plen, sel, max_len)
        with pytest.raises(ValueError):
            t_sha.generate_partial_sha(padded, plen, sel, max_len)


def test_canon_and_binary_format_match():
    for algo in ("simple", "relaxed"):
        assert t_canon.canon_body(BODY, algo) == j_canon.canon_body(BODY, algo)
        assert t_canon.canon_body(BODY, algo, 10) == j_canon.canon_body(BODY, algo, 10)
    for name, value in ((b"Subject", b"  Hi \t there \r\n folded"), (b"X-A", b"")):
        assert t_canon.canon_header_relaxed(name, value) == j_canon.canon_header_relaxed(name, value)
    sig = b"DKIM-Signature: v=1; b=abc\r\n def; bh=xyz"
    assert t_canon.strip_b_value(sig) == j_canon.strip_b_value(sig)
    x = int.from_bytes(np.random.default_rng(2).bytes(256), "big")
    assert t_bf.to_circom_bigint(x) == j_bf.to_circom_bigint(x)
    assert t_bf.chunks_to_big_int(t_bf.to_circom_bigint(x), 121) == x
    data = b"packed bytes into field elements, 31 per field"
    assert t_bf.pack_bytes_to_fields(data, 64) == j_bf.pack_bytes_to_fields(data, 64)
    fields = t_bf.pack_bytes_to_fields(data)
    assert t_bf.unpack_fields_to_bytes(fields, len(data)) == data


@pytest.mark.parametrize("hl,bl", [(448, 192), (640, 768)])
def test_circuit_inputs_equal_jax(port_signer, hl, bl):
    """The port's generate_email_verifier_inputs equals the JAX dict on the
    same email bytes, with the same key, with and without a SHA precompute
    selector."""
    eml = port_signer.sign_email(subject=f"inputs {hl}", body=BODY * 3)
    for sel in (None, "lines."):
        jargs = JArgs(max_headers_length=hl, max_body_length=bl, sha_precompute_selector=sel)
        targs = TArgs(max_headers_length=hl, max_body_length=bl, sha_precompute_selector=sel)
        want = j_inputs(eml, port_signer.resolver(), jargs)
        got = t_inputs(eml, port_signer.resolver(), targs)
        assert got == want
    assert len(got["emailHeader"]) == hl and len(got["emailBody"]) == bl


def test_port_signature_verifies_under_jax_and_cryptography(port_signer):
    eml = port_signer.sign_email()
    res = j_verify(eml, port_signer.resolver())
    assert res.public_key == port_signer.public_key
    assert t_verify(eml, port_signer.resolver()).headers == res.headers
    # the port's DER key and PKCS#1 v1.5 signature, by a library
    key = load_der_public_key(base64.b64decode(port_signer.spki_base64()))
    assert (key.public_numbers().n, key.public_numbers().e) == port_signer.public_key
    sig = res.signature.to_bytes(256, "big")
    key.verify(sig, res.headers, padding.PKCS1v15(), hashes.SHA256())
    # the DNS TXT record parses to the same key in both packages
    txt = port_signer.dns_txt_record()
    assert t_parse_txt(txt) == j_parse_txt(txt) == port_signer.public_key


def test_jax_signature_verifies_under_port():
    signer = JSigner()
    eml = signer.sign_email(body=BODY)
    res = t_verify(eml, signer.resolver())
    assert res.public_key == signer.public_key
    assert res.headers == j_verify(eml, signer.resolver()).headers
    assert t_parse_txt(signer.dns_txt_record()) == signer.public_key
    bad = eml.replace(b"Subject: Hello", b"Subject: Hellp")
    with pytest.raises(DKIMError, match="EBADSIG"):
        t_verify(bad, signer.resolver())
    bad_body = eml.replace(b"lines.", b"linez.")
    with pytest.raises(DKIMError, match="EBODYHASH"):
        t_verify(bad_body, signer.resolver())


def test_signer_is_deterministic_from_its_seed(port_signer):
    again = TSigner(seed=7)
    assert again.public_key == port_signer.public_key
    assert again.sign_email(subject="x") == port_signer.sign_email(subject="x")
    other = TSigner(seed=8)
    assert other.public_key != port_signer.public_key
    n, e = other.public_key
    assert n.bit_length() == 2048 and e == 65537


def test_ed25519_signature_raises_not_implemented(port_signer):
    eml = port_signer.sign_email().replace(b"a=rsa-sha256", b"a=ed25519-sha256")
    with pytest.raises(NotImplementedError, match="ed25519"):
        t_verify(eml, port_signer.resolver())
