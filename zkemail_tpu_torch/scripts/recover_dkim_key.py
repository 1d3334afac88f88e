"""Recover the RSA key of two DKIM-signed emails and write it as JSON.

The port of ``zkemail_tpu/scripts/recover_dkim_key.py``, with the emails
given on the command line (the JAX script reads two fixed reference
emails):

    python -m zkemail_tpu_torch.scripts.recover_dkim_key a.eml b.eml --out dkim_keys.json

The JSON maps "d:s" of the first email's DKIM-Signature to {"n": decimal
string, "e": 65537, "note": ...}, the layout of the JAX package's
tests/fixtures/dkim_keys.json.
See helpers/key_recovery.py for the method (the gcd of s^e - EM(m) over two
signatures by the same key — public information only).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..helpers.dkim import parse_message, parse_tags
from ..helpers.key_recovery import recover_modulus


def _key_name(raw_email: bytes) -> str:
    """"d:s" of the email's first DKIM-Signature."""
    for name, _raw, value in parse_message(raw_email).headers:
        if name == "dkim-signature":
            tags = parse_tags(value)
            return f"{tags.get('d', '')}:{tags.get('s', '')}"
    raise ValueError("no DKIM-Signature header")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="recover a DKIM RSA key from two emails")
    ap.add_argument("emails", nargs="+", type=Path, help="two or more .eml files, one key")
    ap.add_argument("--bits", type=int, default=2048, help="the key's size in bits")
    ap.add_argument("--out", type=Path, default=Path("dkim_keys.json"))
    args = ap.parse_args(argv)

    raws = [p.read_bytes() for p in args.emails]
    n = recover_modulus(raws, bits_hint=args.bits)
    obj = {
        _key_name(raws[0]): {
            "n": str(n),
            "e": 65537,
            "note": (
                "Recovered from the public DKIM signatures of "
                + ", ".join(p.name for p in args.emails)
                + " via zkemail_tpu_torch.helpers.key_recovery (GCD of s^e - EM(m))."
            ),
        }
    }
    args.out.write_text(json.dumps(obj, indent=2))
    print(f"wrote {args.out} (n: {n.bit_length()} bits)")
    return obj


if __name__ == "__main__":
    main()
