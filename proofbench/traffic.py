"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed in, signed emails out.

Email i of a seed is a function of (seed, i) alone, so a run proves a
prefix of its seed's sequence however many requests its window holds.
Each email is drawn as:

* the signing key: ``key_weights`` over the keys of ``keys.json`` (the
  first signs half the mail: a few providers send most of it);
* From and To local parts of ``local_part_chars`` characters, the From
  domain the key's, the To domain one of ``to_domains``;
* a Subject of ``subject_chars`` characters (words of letters and digits);
* a Date and a Message-ID of its own;
* a body of ``body_bytes`` bytes (uniform over the range): lines of words
  of at most 76 characters, each ended by CRLF.

Signing is the client's work: the benchmark signs before its window.
"""

from __future__ import annotations

import hashlib
import json
import random
import string
import time
from pathlib import Path

from . import signer

DAYS = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")
MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
WORD = string.ascii_letters + string.digits
LOCAL = string.ascii_lowercase + string.digits
DATE_RANGE = (1_704_067_200, 1_798_761_600)  # 2024-01-01 .. 2027-01-01 UTC


def load_mix(root: Path, name: str) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _date(ts: int) -> str:
    t = time.gmtime(ts)
    return (f"{DAYS[t.tm_wday]}, {t.tm_mday:02d} {MONTHS[t.tm_mon - 1]} {t.tm_year} "
            f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} +0000")


def _body(rng: random.Random, n: int) -> bytes:
    """n bytes of lines of at most 76 characters, each ended by CRLF, words
    split by single spaces: unchanged by relaxed canonicalisation."""
    out = bytearray()
    while len(out) < n:
        left = n - len(out)
        out += _line(rng, left - 2 if left <= 78 else rng.randint(20, min(76, left - 5)))
        out += b"\r\n"
    return bytes(out)


def _line(rng: random.Random, width: int) -> bytes:
    """width characters of words, no space first, last or next to another."""
    chars = [rng.choice(WORD) for _ in range(width)]
    for j in range(1, width - 1):
        if chars[j - 1] != " " and rng.random() < 1 / 6:
            chars[j] = " "
    return "".join(chars).encode()


class Traffic:
    """The emails of one mix under one seed, signed on demand and kept."""

    def __init__(self, mix: dict, seed: int, keys: list[dict]):
        self.mix, self.seed, self.keys = mix, seed, keys
        self.batch = int(mix["batch"])
        self._emails: list[dict] = []

    def email(self, i: int) -> dict:
        while len(self._emails) <= i:
            self._emails.append(self._make(len(self._emails)))
        return self._emails[i]

    def signed(self) -> int:
        return len(self._emails)

    def _make(self, i: int) -> dict:
        mix = self.mix
        rng = random.Random(f"proofbench:{self.seed}:{i}")
        k = rng.choices(range(len(self.keys)), weights=mix["key_weights"])[0]
        key = self.keys[k]
        body = _body(rng, rng.randint(*mix["body_bytes"]))
        headers = [
            ("From", f"{self._word(rng, LOCAL, 'local_part_chars')}@{key['domain']}"),
            ("To", f"{self._word(rng, LOCAL, 'local_part_chars')}@"
                   f"{rng.choice(mix['to_domains'])}"),
            ("Subject", _line(rng, rng.randint(*mix["subject_chars"])).decode()),
            ("Date", _date(rng.randrange(*DATE_RANGE))),
            ("Message-ID", f"<{rng.getrandbits(64):016x}.{i}@{key['domain']}>"),
        ]
        raw, base = signer.sign_email(key, headers, body)
        return {"raw": raw, "key": k, "modulus": key["n"],
                "header_digest": hashlib.sha256(base).digest(),
                "header_bytes": len(base), "body_bytes": len(body)}

    def _word(self, rng: random.Random, alphabet: str, lengths: str) -> str:
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(*self.mix[lengths])))


def sha_padded(n: int) -> int:
    """SHA-256's padded length of n bytes."""
    return (n + 9 + 63) // 64 * 64
