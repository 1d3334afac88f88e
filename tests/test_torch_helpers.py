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
    """An a=ed25519-sha256 tag over an RSA key. The port once raised
    NotImplementedError here; it now verifies ed25519 as the JAX package
    does, where an RSA key cannot check an ed25519 signature: EBADSIG in
    both (tests/test_torch_dkim_ed25519.py covers real ed25519 mail)."""
    from zkemail_tpu.helpers.dkim import DKIMError as JDKIMError

    eml = port_signer.sign_email().replace(b"a=rsa-sha256", b"a=ed25519-sha256")
    with pytest.raises(JDKIMError) as jerr:
        j_verify(eml, port_signer.resolver())
    with pytest.raises(DKIMError) as terr:
        t_verify(eml, port_signer.resolver())
    assert terr.value.code == jerr.value.code == "EBADSIG"


# ---------------------------------------------------------------------------
# Strict DER: the port refuses the keys cryptography refuses (JAX package)
# ---------------------------------------------------------------------------

def _der(tag: int, body: bytes, long_form: int = 0) -> bytes:
    n = len(body)
    if long_form:
        return bytes([tag, 0x80 | long_form]) + n.to_bytes(long_form, "big") + body
    if n < 0x80:
        return bytes([tag, n]) + body
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(nb)]) + nb + body


def _uint(x: int) -> bytes:
    return _der(0x02, x.to_bytes(x.bit_length() // 8 + 1, "big"))


def _spki(key_body: bytes) -> bytes:
    alg = _der(0x30, _der(0x06, bytes.fromhex("2a864886f70d010101")) + _der(0x05, b""))
    return _der(0x30, alg + _der(0x03, b"\x00" + key_body))


def _bad_keys(n: int, e: int) -> dict:
    return {
        # the modulus without its leading 0x00: a negative INTEGER
        "negative_modulus": _spki(_der(0x30, _der(0x02, n.to_bytes(256, "big")) + _uint(e))),
        "negative_exponent": _spki(_der(0x30, _uint(n) + _der(0x02, b"\xff"))),
        "non_minimal_integer": _spki(_der(0x30, _der(0x02, b"\x00" + n.to_bytes(257, "big"))
                                          + _uint(e))),
        "long_form_short_length": _spki(_der(0x30, _uint(n) + _der(0x02, e.to_bytes(3, "big"),
                                                                   long_form=1))),
    }


@pytest.mark.parametrize("case", ["negative_modulus", "negative_exponent",
                                  "non_minimal_integer", "long_form_short_length"])
def test_der_reader_refuses_what_jax_refuses(port_signer, case):
    """Each malformed SPKI is refused by both packages: EINVALIDVAL when
    strict, None otherwise; the well-formed key parses in both."""
    from zkemail_tpu.helpers.dkim import DKIMError as JDKIMError

    n, e = port_signer.public_key
    txt = "v=DKIM1; k=rsa; p=" + base64.b64encode(_bad_keys(n, e)[case]).decode()
    assert t_parse_txt(txt) is None and j_parse_txt(txt) is None
    with pytest.raises(JDKIMError) as jerr:
        j_parse_txt(txt, strict=True)
    with pytest.raises(DKIMError) as terr:
        t_parse_txt(txt, strict=True)
    assert terr.value.code == jerr.value.code == "EINVALIDVAL"
    good = "v=DKIM1; k=rsa; p=" + base64.b64encode(_spki(_der(0x30, _uint(n) + _uint(e)))).decode()
    assert t_parse_txt(good, strict=True) == j_parse_txt(good, strict=True) == (n, e)


# ---------------------------------------------------------------------------
# The a= tag, the sanitizer retries and the tools module
# ---------------------------------------------------------------------------

def _resign(signer, eml: bytes, old: bytes, new: bytes) -> bytes:
    """eml with `old` replaced by `new` in its DKIM-Signature header and the
    signature made anew over the changed header (the port's signer key)."""
    from zkemail_tpu_torch.helpers.dkim import build_signature_base, parse_message, parse_tags
    from zkemail_tpu_torch.helpers.testkit import pkcs1v15_sha256_sign

    head, body = eml.split(b"\r\n\r\n", 1)
    lines = head.split(b"\r\n")
    i = next(k for k, ln in enumerate(lines) if ln.lower().startswith(b"dkim-signature:"))
    unsigned = lines[i].replace(old, new).split(b" b=")[0] + b" b="
    raw = b"\r\n".join(lines[:i] + [unsigned] + lines[i + 1:]) + b"\r\n\r\n" + body
    parsed = parse_message(raw)
    sig_raw = next(r for (nm, r, v) in parsed.headers if nm == "dkim-signature")
    base = build_signature_base(parsed, sig_raw, parse_tags(sig_raw.split(b":", 1)[1]))
    sig = pkcs1v15_sha256_sign(signer.public_key[0], signer._d, base)
    lines[i] = unsigned + base64.b64encode(sig)
    return b"\r\n".join(lines) + b"\r\n\r\n" + body


@pytest.mark.parametrize("algo", [b"RSA-SHA256", b"ED25519-SHA256"])
def test_upper_case_algorithm_refused_as_jax(port_signer, algo):
    """a= is compared case-sensitively after validate_algorithm: an
    upper-case tag is EINVALIDALGO in both packages, never verified nor
    NotImplementedError."""
    from zkemail_tpu.helpers.dkim import DKIMError as JDKIMError

    eml = _resign(port_signer, port_signer.sign_email(), b"a=rsa-sha256", b"a=" + algo)
    assert b"a=" + algo in eml
    with pytest.raises(JDKIMError) as jerr:
        j_verify(eml, port_signer.resolver())
    with pytest.raises(DKIMError) as terr:
        t_verify(eml, port_signer.resolver())
    assert terr.value.code == jerr.value.code == "EINVALIDALGO"
    # the same email re-signed with the lower-case tag verifies in both
    ok = _resign(port_signer, eml, b"a=" + algo, b"a=rsa-sha256")
    assert t_verify(ok, port_signer.resolver()).algo == j_verify(ok, port_signer.resolver()).algo


def _mangled(signer, case: str) -> bytes:
    if case == "remove_labels":
        eml = signer.sign_email(subject="Hello from the card")
        return eml.replace(b"Subject: Hello", b"Subject: [ext] Hello", 1)
    if case == "bare_lf":
        return signer.sign_email().replace(b"\r\n", b"\n")
    if case == "revert_google_message_id":
        eml = signer.sign_email()
        orig = b"<test-12345@" + signer.domain.encode() + b">"
        return eml.replace(b"Message-ID: " + orig, b"Message-ID: <fwd-1@mail.gmail.com>\r\n"
                           b"X-Google-Original-Message-ID: " + orig, 1)
    if case == "sanitize_tabs":
        eml = signer.sign_email(body=b"col1\tcol2\r\n")
        return eml.replace(b"col1\tcol2", b"col1=09col2")
    if case == "clean":
        return signer.sign_email(subject="untouched")
    raise ValueError(case)


@pytest.mark.parametrize("case,applied", [
    ("clean", None), ("remove_labels", "remove_labels"),
    ("bare_lf", None),  # repaired by parse_message's line-ending normalization
    ("revert_google_message_id", "revert_google_message_id"),
    ("sanitize_tabs", "sanitize_tabs")])
def test_sanitizer_retries_equal_jax(port_signer, case, applied):
    """verify_dkim_signature with its sanitizer retries: the port's result
    equals the JAX package's field by field (applied_sanitization,
    status, auth_results and circuit_provable included); without the
    retries a mangled email fails alike in both."""
    import dataclasses

    eml = _mangled(port_signer, case)
    want = j_verify(eml, port_signer.resolver())
    got = t_verify(eml, port_signer.resolver())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.applied_sanitization == applied
    assert got.circuit_provable and got.auth_results.startswith("dkim=pass")
    if want.applied_sanitization is not None:
        from zkemail_tpu.helpers.dkim import DKIMError as JDKIMError

        with pytest.raises(JDKIMError) as jerr:
            j_verify(eml, port_signer.resolver(), enable_sanitization=False)
        with pytest.raises(DKIMError) as terr:
            t_verify(eml, port_signer.resolver(), enable_sanitization=False,
                     fall_back_to_maybe_expired_keys=True)
        assert terr.value.code == jerr.value.code


def test_unrepairable_email_raises_the_unsanitized_error(port_signer):
    eml = port_signer.sign_email().replace(b"It proves", b"It proved")
    from zkemail_tpu.helpers.dkim import DKIMError as JDKIMError

    with pytest.raises(JDKIMError) as jerr:
        j_verify(eml, port_signer.resolver())
    with pytest.raises(DKIMError) as terr:
        t_verify(eml, port_signer.resolver())
    assert terr.value.code == jerr.value.code == "EBODYHASH"


def test_tools_equal_jax():
    """The port's tools module on the cases of the JAX package's tools tests."""
    import zkemail_tpu.helpers.tools as JT
    import zkemail_tpu_torch.helpers.tools as TT

    for d in ("mail.google.com", "google.com", "a.b.co.uk", "news.bbc.co.uk", "com",
              "co.uk", "", "x.y.com.au"):
        assert TT.psl_get(d) == JT.psl_get(d)
    for args in (("mail.example.com", ["example.com"]), ("example.com", ["mailer.example.com"]),
                 ("example.com", ["other.org"]), ("sub.example.com", ["sub.example.com"], True),
                 ("sub.example.com", ["example.com"], True),
                 ("news.bbc.co.uk", ["www.bbc.co.uk"]), ("news.bbc.co.uk", "bbc2.co.uk")):
        assert TT.get_alignment(*args) == JT.get_alignment(*args)
    for d in ("EXAMPLE.Com ", "bücher.example", None):
        assert TT.format_domain(d) == JT.format_domain(d)
    status = {"result": "pass", "comment": "body hash ok)",
              "header": {"i": "@example.com", "s": "sel1", "a": "rsa-sha256", "b": ""}}
    for s in (status, None, {"result": "fail", "policy": {"x": "has space"}}):
        assert TT.format_auth_header_row("dkim", s) == JT.format_auth_header_row("dkim", s)
    for v in ("simple-token", "has space", 'q"uote', "a)b\\c", "\x01ctl"):
        assert TT.escape_prop_value(v) == JT.escape_prop_value(v)
        assert TT.escape_comment_value(v) == JT.escape_comment_value(v)
    for algo, strict in (("rsa-sha256", False), ("ed25519-sha256", False), ("rsa-sha1", False),
                         ("rsa-sha1", True), ("dsa-sha256", False), ("rsasha256", False),
                         ("rsa-md5", False), ("", False), ("RSA-SHA256", True)):
        outcomes = []
        for mod in (JT, TT):
            try:
                mod.validate_algorithm(algo, strict=strict)
                outcomes.append(None)
            except ValueError as exc:
                outcomes.append((exc.code, str(exc)))
        assert outcomes[0] == outcomes[1], algo
