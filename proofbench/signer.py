"""The benchmark's DKIM signer: seeded RSA keys, PKCS#1 v1.5 signatures and
relaxed/relaxed canonicalisation, in plain Python.

A frozen copy of ``zkemail_tpu_torch/helpers/testkit.py``'s
``LocalDKIMSigner`` (with the pieces of ``helpers/canon.py`` and
``helpers/dkim.py::build_signature_base`` it uses), so that the traffic
imports nothing of the program. The emails are laid out as that signer
lays them out: five signed headers, then the DKIM-Signature header, whose
``b=`` signs the relaxed signature base. The signature is computed by CRT
(equal to ``pow(m, d, n)``), and the signature base is returned beside
the email: its SHA-256 digest is what the circuit's header hash publishes.

    python proofbench/signer.py

writes ``proofbench/keys.json`` from the seeds listed in ``KEY_SEEDS``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import random
import re
import sys
from pathlib import Path

RSA_E = 65537
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")
_SMALL_PRIMES = [p for p in range(3, 2000) if all(p % d for d in range(2, int(p ** 0.5) + 1))]
SIGNED_HEADERS = "from:to:subject:date:message-id"
WSP_RUN = re.compile(rb"[ \t]+")

# (domain, selector, seed) of the four signing keys in keys.json
KEY_SEEDS = [
    ("mail.alpha-provider.example", "s2026a", 1_000_003),
    ("beta-mail.example.net", "k1", 1_000_033),
    ("gamma.example.org", "dkim2026", 1_000_037),
    ("delta-post.example.com", "sel7", 1_000_039),
]
KEYS_PATH = Path(__file__).resolve().parent / "keys.json"


def _is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, rng: random.Random) -> int:
    while True:
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if (c - 1) % RSA_E and _is_probable_prime(c, rng):
            return c


def generate_rsa_key(bits: int, seed: int) -> dict:
    """n, d, p, q of an RSA key (e = 65537), a function of `seed` alone (the
    same key as testkit.generate_rsa_key for the seed)."""
    rng = random.Random(seed)
    while True:
        p = _random_prime(bits // 2, rng)
        q = _random_prime(bits - bits // 2, rng)
        if p != q:
            break
    return {"n": p * q, "d": pow(RSA_E, -1, (p - 1) * (q - 1)), "p": p, "q": q}


def pkcs1v15_sha256_sign(key: dict, message: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 over SHA-256 (RFC 8017 section 8.2.1), by CRT."""
    n, d, p, q = key["n"], key["d"], key["p"], key["q"]
    k = (n.bit_length() + 7) // 8
    t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    m = int.from_bytes(b"\x00\x01" + b"\xff" * (k - 3 - len(t)) + b"\x00" + t, "big")
    sp, sq = pow(m, d % (p - 1), p), pow(m, d % (q - 1), q)
    s = sq + q * ((sp - sq) * pow(q, -1, p) % p)
    return s.to_bytes(k, "big")


def canon_header_relaxed(name: bytes, value: bytes) -> bytes:
    value = value.replace(b"\r\n", b"").replace(b"\n", b"")
    return name.strip().lower() + b":" + WSP_RUN.sub(b" ", value).strip()


def canon_body_relaxed(body: bytes) -> bytes:
    if not body:
        return b""
    body = re.sub(rb"(?<!\r)\n", b"\r\n", body)
    lines = [WSP_RUN.sub(b" ", ln.rstrip(b" \t")) for ln in body.split(b"\r\n")]
    out = re.sub(rb"(\r\n)*$", b"", b"\r\n".join(lines))
    return out + b"\r\n" if out else out


def sign_email(key: dict, headers: list, body: bytes) -> tuple:
    """(email bytes, signature base) of `body` under the
    signed `headers` [(name, value)] (From, To, Subject, Date, Message-ID in
    that order), signed relaxed/relaxed by `key` (with "domain", "selector")."""
    bh = base64.b64encode(hashlib.sha256(canon_body_relaxed(body)).digest()).decode()
    dkim_value = (f" v=1; a=rsa-sha256; c=relaxed/relaxed; d={key['domain']};"
                  f" s={key['selector']}; h={SIGNED_HEADERS}; bh={bh}; b=")
    base = b"\r\n".join(
        [canon_header_relaxed(k.encode(), b" " + v.encode()) for k, v in headers]
        + [canon_header_relaxed(b"DKIM-Signature", dkim_value.encode())])
    sig = base64.b64encode(pkcs1v15_sha256_sign(key, base))
    head = b"".join(k.encode() + b": " + v.encode() + b"\r\n" for k, v in headers)
    raw = head + b"DKIM-Signature:" + dkim_value.encode() + sig + b"\r\n\r\n" + body
    return raw, base


def load_keys(path: Path = KEYS_PATH) -> list[dict]:
    keys = json.loads(path.read_text())["keys"]
    return [{k: (int(v) if k in ("n", "d", "p", "q") else v) for k, v in key.items()}
            for key in keys]


def main() -> int:
    keys = []
    for domain, selector, seed in KEY_SEEDS:
        key = generate_rsa_key(2048, seed)
        keys.append({"domain": domain, "selector": selector, "seed": seed,
                     **{k: str(v) for k, v in key.items()}})
    KEYS_PATH.write_text(json.dumps({
        "made_by": "python proofbench/signer.py (generate_rsa_key(2048, seed))",
        "keys": keys}, indent=1) + "\n")
    print(f"wrote {KEYS_PATH}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
