"""ed25519-sha256 DKIM, the DoH / archive / chain resolvers and key
recovery in the port, against the JAX package on the CPU.

The port verifies ed25519 in Python integers (helpers/ed25519.py, no
``cryptography``); the JAX package through ``cryptography``. Both packages'
resolvers run under the same fake ``urlopen`` (no network). Keys and emails
come from seeds. Tolerance: exact equality of keys, result fields, error
codes and recovered moduli."""

import base64
import io
import json
import logging
import random

import pytest
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

from zkemail_tpu.helpers import dkim as JD
from zkemail_tpu.helpers import dns as JDNS
from zkemail_tpu.helpers import input_gen as JIG
from zkemail_tpu.helpers import key_recovery as JKR
from zkemail_tpu.helpers.testkit import LocalEd25519DKIMSigner as JEdSigner
from zkemail_tpu_torch.helpers import dkim as TD
from zkemail_tpu_torch.helpers import dns as TDNS
from zkemail_tpu_torch.helpers import ed25519 as ED
from zkemail_tpu_torch.helpers import input_gen as TIG
from zkemail_tpu_torch.helpers import key_recovery as TKR
from zkemail_tpu_torch.helpers.sha_utils import sha256
from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner as TSigner
from zkemail_tpu_torch.helpers.testkit import LocalEd25519DKIMSigner as TEdSigner
from zkemail_tpu_torch.scripts import recover_dkim_key

PACKAGES = {"jax": (JD, JDNS), "port": (TD, TDNS)}
TXT_A = TSigner(key_size=1024, seed=31).dns_txt_record()
TXT_B = TSigner(key_size=1024, seed=32).dns_txt_record()
TXT_ED = TEdSigner(seed=33).dns_txt_record()
TXT_BAD = "v=DKIM1; k=dsa; p=AAAA"


# ---------------------------------------------------------------------------
# resolvers under one fake urlopen
# ---------------------------------------------------------------------------

class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _doh(txts):
    return _Resp(json.dumps({"Answer": [{"type": 16, "data": t} for t in txts]}).encode())


def _archive(entries):
    return _Resp(json.dumps(entries).encode())


P2 = ["https://p1/?name={name}", "https://p2/?name={name}"]


def _per_provider(a, b):
    return lambda url, n, state: _doh(a if "p1" in url else b)


def _fail_first(url, n, state):
    if state.setdefault("fails", 0) < 1:
        state["fails"] += 1
        raise OSError("transient")
    return _doh([TXT_A])


def _p1_down(url, n, state):
    if "p1" in url:
        raise OSError("down")
    return _doh([TXT_A])


def _archive_handler(entries):
    return lambda url, n, state: _archive(entries)


def _down(url, n, state):
    raise OSError("down")


# case: (handler, resolver factory over a dns module)
CASES = {
    "doh_agree": (_per_provider([TXT_A], [TXT_A]), lambda D: D.DoHResolver(providers=P2)),
    "doh_mismatch_first": (_per_provider([TXT_A], [TXT_B]), lambda D: D.DoHResolver(providers=P2)),
    "doh_mismatch_union": (_per_provider([TXT_A], [TXT_B]),
                           lambda D: D.DoHResolver(providers=P2, union_on_mismatch=True)),
    "doh_retries": (_fail_first, lambda D: D.DoHResolver(providers=P2[:1], retries=2)),
    "doh_unreachable_skipped": (_p1_down, lambda D: D.DoHResolver(providers=P2, retries=2)),
    "doh_ed25519_and_rsa": (_per_provider([TXT_ED, TXT_A], [TXT_A, TXT_ED]),
                            lambda D: D.DoHResolver(providers=P2)),
    "doh_only_bad_records": (_per_provider([TXT_BAD], [TXT_BAD]), lambda D: D.DoHResolver(providers=P2)),
    "doh_all_down": (_down, lambda D: D.DoHResolver(providers=P2)),
    "archive": (_archive_handler([{"selector": "sel", "value": TXT_A},
                                  {"selector": "other", "value": TXT_B},
                                  {"selector": "sel", "value": TXT_ED}]),
                lambda D: D.ArchiveResolver(url="https://archive/?d={domain}")),
    "archive_bad_only": (_archive_handler([{"selector": "sel", "value": TXT_BAD}]),
                         lambda D: D.ArchiveResolver(url="https://archive/?d={domain}")),
    "archive_down": (_down, lambda D: D.ArchiveResolver(url="https://archive/?d={domain}")),
    "chain": (_archive_handler([{"selector": "sel", "value": TXT_B},
                                {"selector": "sel", "value": TXT_A}]),
              lambda D: D.ChainResolver(D.StaticResolver({("example.com", "sel"): [
                  D.parse_dkim_txt(TXT_A)]}), D.ArchiveResolver(url="https://archive/?d={domain}"))),
    "chain_error_then_keys": (_per_provider([TXT_BAD], [TXT_BAD]),
                              lambda D: D.ChainResolver(D.DoHResolver(providers=P2),
                                                        D.StaticResolver({("example.com", "sel"): [
                                                            D.parse_dkim_txt(TXT_B)]}))),
    "chain_error_only": (_per_provider([TXT_BAD], [TXT_BAD]),
                         lambda D: D.ChainResolver(D.DoHResolver(providers=P2),
                                                   D.StaticResolver({}))),
}


def _outcome(monkeypatch, caplog, handler, make, which):
    dkim_mod, dns_mod = PACKAGES[which]
    calls, state = [], {}

    def fake_urlopen(req, timeout=None):
        url = req.full_url if hasattr(req, "full_url") else str(req)
        calls.append(url)
        return handler(url, len(calls), state)

    monkeypatch.setattr(dns_mod.urllib.request, "urlopen", fake_urlopen)
    caplog.clear()
    try:
        keys = make(dns_mod)("example.com", "sel")
        result = ("keys", keys)
    except dkim_mod.DKIMError as exc:
        result = ("error", exc.code)
    warned = any("cross-check mismatch" in r.getMessage() for r in caplog.records
                 if r.name == dns_mod.__name__)
    return result, warned, calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolvers_equal_jax(monkeypatch, caplog, case):
    handler, make = CASES[case]
    with caplog.at_level(logging.WARNING):
        jax_out = _outcome(monkeypatch, caplog, handler, make, "jax")
        port_out = _outcome(monkeypatch, caplog, handler, make, "port")
    assert port_out == jax_out
    if case in ("doh_agree", "doh_mismatch_first", "doh_retries", "doh_unreachable_skipped"):
        assert port_out[0] == ("keys", [TDNS.parse_dkim_txt(TXT_A)])
    if case == "doh_mismatch_union":
        assert len(port_out[0][1]) == 2 and port_out[1]


# ---------------------------------------------------------------------------
# ed25519 key records
# ---------------------------------------------------------------------------

def _spki(oid: bytes, key: bytes) -> bytes:
    alg = b"\x30" + bytes([len(oid) + 2]) + b"\x06" + bytes([len(oid)]) + oid
    bits = b"\x03" + bytes([len(key) + 1]) + b"\x00" + key
    body = alg + bits
    return b"\x30" + bytes([len(body)]) + body


def _records():
    raw = TEdSigner(seed=40).public_key[1]
    rsa_spki = base64.b64decode(TXT_A.split("p=")[1])

    def rec(k, der):
        return f"v=DKIM1; k={k}; p={base64.b64encode(der).decode()}"

    return [
        TXT_ED,
        rec("ed25519", raw),
        rec("ed25519", _spki(bytes.fromhex("2b6570"), raw)),  # SPKI-wrapped
        rec("ed25519", _spki(bytes.fromhex("2b656e"), raw)),  # an X25519 SPKI
        rec("ed25519", raw[:31]),
        rec("ed25519", raw + b"\x00"),
        rec("ed25519", rsa_spki),  # an RSA key under k=ed25519
        rec("rsa", _spki(bytes.fromhex("2b6570"), raw)),  # ed25519 SPKI under k=rsa
        "v=DKIM1; k=ED25519; p=" + base64.b64encode(raw).decode(),
        "k=ed25519; p=",
        "k=ed25519; p=!!!!",
        TXT_A,
    ]


def _parse(dns_mod, dkim_mod, txt, strict):
    try:
        return ("ok", dns_mod.parse_dkim_txt(txt, strict=strict))
    except dkim_mod.DKIMError as exc:
        return ("error", exc.code)


@pytest.mark.parametrize("strict", [False, True])
def test_parse_ed25519_records_equal_jax(strict):
    outs = [(_parse(JDNS, JD, t, strict), _parse(TDNS, TD, t, strict)) for t in _records()]
    for i, (j, t) in enumerate(outs):
        assert t == j, i
    assert outs[0][1] == ("ok", TEdSigner(seed=33).public_key)


# ---------------------------------------------------------------------------
# ed25519 signatures
# ---------------------------------------------------------------------------

def _fields(res):
    return (res.public_key, res.headers, res.body, res.body_hash, res.signing_domain,
            res.selector, res.algo, res.format, res.modulus_length, res.status,
            res.applied_sanitization, res.auth_results, res.circuit_provable, res.signature)


def _error(verify, eml, resolver, err_cls):
    with pytest.raises(err_cls) as exc:
        verify(eml, resolver)
    return exc.value.code


@pytest.mark.parametrize("canon", ["relaxed/relaxed", "simple/simple"])
def test_port_signed_ed25519_mail_verifies_in_both(canon):
    signer = TEdSigner(seed=3)
    eml = signer.sign_email(canon=canon, subject="ed25519 from the port")
    j, t = JD.verify_dkim_signature(eml, signer.resolver()), TD.verify_dkim_signature(
        eml, signer.resolver())
    assert _fields(t) == _fields(j)
    assert t.circuit_provable is False and t.algo == "ed25519-sha256"
    # the port's signature is RFC 8032's: cryptography signs the same bytes
    sig = base64.b64decode(eml.split(b"; b=")[1].split(b"\r\n")[0])
    lib = Ed25519PrivateKey.from_private_bytes(signer._secret).sign(sha256(t.headers))
    assert sig == lib
    for bad, code in ((eml.replace(b"test body", b"test bodY"), "EBODYHASH"),
                      (eml.replace(b"Subject: ed25519", b"Subject: ED25519"), "EBADSIG")):
        assert _error(TD.verify_dkim_signature, bad, signer.resolver(), TD.DKIMError) == code
        assert _error(JD.verify_dkim_signature, bad, signer.resolver(), JD.DKIMError) == code


def test_jax_signed_ed25519_mail_verifies_in_port():
    signer = JEdSigner()
    eml = signer.sign_email(body=b"Signed by the JAX package.\r\n")
    j, t = JD.verify_dkim_signature(eml, signer.resolver()), TD.verify_dkim_signature(
        eml, signer.resolver())
    assert _fields(t) == _fields(j)
    assert TDNS.parse_dkim_txt(signer.dns_txt_record()) == signer.public_key
    bad = eml.replace(b"JAX package", b"JAX packagE")
    assert _error(TD.verify_dkim_signature, bad, signer.resolver(), TD.DKIMError) == "EBODYHASH"
    # keys of both kinds for one selector: each signature finds its own
    rsa = TSigner(key_size=1024, seed=34)
    both = TDNS.StaticResolver({(signer.domain, signer.selector): [rsa.public_key,
                                                                   signer.public_key]})
    assert _fields(TD.verify_dkim_signature(eml, both)) == _fields(
        JD.verify_dkim_signature(eml, both))


def test_ed25519_edge_encodings_decide_as_jax():
    """Non-canonical keys and R, S >= L, x = 0 with the sign bit: the port's
    verify decides as the JAX package's (cryptography, OpenSSL)."""
    rng = random.Random(5)
    secret = rng.randbytes(32)
    pub, msg = ED.public_key(secret), rng.randbytes(48)
    sig = ED.sign(secret, sha256(msg))
    s_int = int.from_bytes(sig[32:], "little")
    ident = (1).to_bytes(32, "little")
    cases = [
        (pub, sig, msg),
        (pub, sig, msg + b"x"),
        (pub, sig[:32] + (s_int + ED.L).to_bytes(32, "little"), msg),
        (pub, sig[:63], msg),
        (pub[:31], sig, msg),
        (ident, ident + bytes(32), msg),  # the identity key, R = identity, S = 0
        ((ED.P + 1).to_bytes(32, "little"), ident + bytes(32), msg),  # y >= p
        ((1 | 1 << 255).to_bytes(32, "little"), ident + bytes(32), msg),  # x = 0, sign 1
        (ident, (ED.P + 1).to_bytes(32, "little") + bytes(32), msg),  # R not canonical
        ((2).to_bytes(32, "little"), sig, msg),  # no x for this y
    ]
    for y0 in range(19):
        for sign in (0, 1):
            key = ((ED.P + y0) | sign << 255).to_bytes(32, "little")
            cases.append((key, ident + bytes(32), msg))
    got = [TD.ed25519_sha256_verify(*c) for c in cases]
    assert got == [JD.ed25519_sha256_verify(*c) for c in cases]
    assert got[0] and not got[1] and not got[2]


def test_ed25519_results_are_refused_for_the_circuit():
    signer = TEdSigner(seed=4)
    eml = signer.sign_email()
    errors = []
    for ig, args in ((JIG, JIG.InputGenArgs()), (TIG, TIG.InputGenArgs())):
        with pytest.raises(ValueError) as exc:
            ig.generate_email_verifier_inputs(eml, signer.resolver(), args)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "cannot prove" in errors[1]


# ---------------------------------------------------------------------------
# key recovery
# ---------------------------------------------------------------------------

def _two_emails(signer):
    return [signer.sign_email(subject="Recover me"),
            signer.sign_email(subject="And me", body=b"A second body.\r\n")]


def test_recover_modulus_512(tmp_path, capsys):
    """A seeded 512-bit key (a 2048-bit one takes a minute of gcd): the
    port's recover_dkim_key script recovers it. The steps equal the JAX
    module's, but for the length at which EM(m) is encoded: the key's 64
    bytes in the port, where the JAX module takes max(signature bytes, 256)
    and so recovers no key shorter than 2048 bits."""
    signer = TSigner(key_size=512, seed=12)
    emails = _two_emails(signer)
    paths = [tmp_path / f"{i}.eml" for i in range(2)]
    for path, eml in zip(paths, emails):
        path.write_bytes(eml)
    out = recover_dkim_key.main([*map(str, paths), "--bits", "512", "--out",
                                 str(tmp_path / "keys.json")])
    assert json.loads((tmp_path / "keys.json").read_text()) == out
    assert out == {f"{signer.domain}:{signer.selector}": {
        "n": str(signer.public_key[0]), "e": 65537, "note": out[next(iter(out))]["note"]}}
    for eml in emails:
        assert TKR.signature_and_message(eml) == JKR.signature_and_message(eml)
        s, em = TKR.signature_and_message(eml, k=64)
        assert pow(s, 65537, signer.public_key[0]) == em
        assert JKR.signature_and_message(eml)[1] != em


def test_gcd_without_libgmp_equals_jax(monkeypatch):
    def no_gmp():
        raise OSError("no libgmp")

    pairs = [(7, 3), (11, 5), (1234, 99)]
    with_gmp = TKR._gcd_of_sig_residues(pairs)
    assert with_gmp == JKR._gcd_of_sig_residues(pairs)
    monkeypatch.setattr(TKR, "_Gmp", no_gmp)
    monkeypatch.setattr(JKR, "_Gmp", no_gmp)
    assert TKR._gcd_of_sig_residues(pairs) == JKR._gcd_of_sig_residues(pairs) == with_gmp
