"""The traffic: deterministic for each seed, every email fits its
configuration and verifies under its key, the mix's ranges hold."""

import hashlib
import json

import pytest

from proofbench import harness as H
from proofbench import signer
from proofbench.traffic import Traffic, load_mix, sha_padded

KEYS = signer.load_keys()
SEED = 2**31 + 12345  # seeds may pass 32 signed bits


def test_same_seed_same_emails_other_seed_other_emails():
    mix = load_mix(H.HERE, "b8_short")
    a, b, c = Traffic(mix, SEED, KEYS), Traffic(mix, SEED, KEYS), Traffic(mix, SEED + 1, KEYS)
    assert [a.email(i)["raw"] for i in range(6)] == [b.email(i)["raw"] for i in range(6)]
    assert {a.email(i)["raw"] for i in range(6)}.isdisjoint(c.email(i)["raw"] for i in range(6))
    assert len({a.email(i)["raw"] for i in range(6)}) == 6  # no email twice


@pytest.mark.parametrize("cell", ["full1024.b8", "full4kb.b1", "full1024.b1", "full4kb.b8"])
def test_every_email_fits_and_keeps_to_its_mix(cell):
    bench = json.loads((H.REPO / "BENCHMARK.json").read_text())
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    spec = H.cell_spec(bench, cell)
    cfg, mix = spec["config"], spec["mix"]
    t = Traffic(mix, SEED, KEYS)
    lo, hi = mix["body_bytes"]
    for i in range(24):
        e = t.email(i)
        assert lo <= e["body_bytes"] <= hi
        assert sha_padded(e["header_bytes"]) <= cfg["max_headers_length"]
        assert sha_padded(e["body_bytes"]) <= cfg["max_body_length"]
        head, body = e["raw"].split(b"\r\n\r\n", 1)
        assert len(body) == e["body_bytes"] and signer.canon_body_relaxed(body) == body
        subject = next(ln for ln in head.split(b"\r\n") if ln.startswith(b"Subject: "))
        assert mix["subject_chars"][0] <= len(subject) - 9 <= mix["subject_chars"][1]


def test_keys_are_the_seeded_keygens_and_the_first_signs_half():
    key = signer.generate_rsa_key(2048, KEYS[1]["seed"])
    assert all(key[k] == KEYS[1][k] for k in ("n", "d", "p", "q"))
    t = Traffic(load_mix(H.HERE, "b1_short"), SEED, KEYS)
    first = sum(t.email(i)["key"] == 0 for i in range(400))
    assert 160 <= first <= 240


def test_emails_verify_under_the_programs_dkim_with_the_digest_the_reference_uses():
    from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature

    t = Traffic(load_mix(H.HERE, "b8_long"), SEED, KEYS)
    resolver = H._resolver(KEYS)
    for i in range(4):
        e = t.email(i)
        res = verify_dkim_signature(e["raw"], resolver)
        assert hashlib.sha256(res.headers).digest() == e["header_digest"]
        assert res.public_key[0] == e["modulus"]
