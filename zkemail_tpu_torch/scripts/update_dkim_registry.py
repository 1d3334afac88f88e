"""DKIM registry updater: crawl selectors, hash keys, emit registry updates.

The port of ``zkemail_tpu/scripts/update_dkim_registry.py``, after
zk-email-verify scripts/dkim/update-dkim-registry.ts: bruteforce ~47 common
selectors per domain, chunk the RSA modulus into 121x17 limbs, compute the
Poseidon(9x242) key hash — identical to the circuit's pubkeyHash — and
write JSON. The on-chain push is emitted as calldata JSON; any web3 client
can submit it.

One difference from the JAX script: a crawled ed25519 key is skipped (the
registry holds the hashes of RSA keys, the circuit proves RSA only), where
the JAX script's crawl fails with a TypeError on it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..core.poseidon import poseidon_large
from ..helpers.dns import ChainResolver, DoHResolver, StaticResolver

# selector bruteforce list (update-dkim-registry.ts:125-175)
COMMON_SELECTORS = [
    "default", "google", "google2", "gmail", "s1", "s2", "s3", "k1", "k2", "k3",
    "selector", "selector1", "selector2", "dkim", "dkim1", "dkim2", "mail",
    "email", "smtp", "mx", "class", "beta", "v1", "v2", "v3", "m1", "mailjet",
    "mandrill", "everlytickey1", "everlytickey2", "eversrv", "mxvault",
    "dk", "dk1", "dk2", "delta", "gamma", "zendesk1", "zendesk2", "pm",
    "protonmail", "protonmail2", "protonmail3", "amazonses", "ses", "sig1", "litesrv",
]

POSEIDON_BITS_PER_CHUNK = 242 // 2  # merged pairs of 121-bit limbs
POSEIDON_CHUNKS = 9


def pubkey_hash(modulus: int) -> int:
    """The circuit's pubkeyHash: poseidonLarge(modulus, 121, 9)."""
    return poseidon_large(modulus, 121, POSEIDON_CHUNKS)


def crawl_domains(domains: list[str], resolver=None, selectors=None) -> dict:
    """domain -> list of {selector, modulus, exponent, hash} entries."""
    resolver = resolver or ChainResolver(DoHResolver())
    selectors = selectors or COMMON_SELECTORS
    out = {}
    for domain in domains:
        entries = []
        for sel in selectors:
            try:
                keys = resolver(domain, sel)
            except Exception:
                keys = []
            for n, e in keys:
                if n == "ed25519":
                    continue
                entries.append(
                    {
                        "selector": sel,
                        "modulus": hex(n),
                        "exponent": e,
                        "pubkeyHash": str(pubkey_hash(n)),
                    }
                )
        if entries:
            out[domain] = entries
    return out


def registry_calldata(crawled: dict) -> list[dict]:
    """DKIMRegistry.setDKIMPublicKeyHashes calldata descriptors."""
    calls = []
    for domain, entries in crawled.items():
        domain_hash = _keccak_hex(domain)
        calls.append(
            {
                "method": "setDKIMPublicKeyHashes",
                "domainHash": domain_hash,
                "keyHashes": [hex(int(e["pubkeyHash"])) for e in entries],
            }
        )
    return calls


def _keccak_hex(domain: str) -> str:
    from ..utils.keccak import keccak_256

    return "0x" + keccak_256(domain.encode()).hex()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--domains-file", type=Path, help="one domain per line")
    ap.add_argument("--domains", nargs="*", default=[])
    ap.add_argument("--output", type=Path, default=Path("dkim_registry.json"))
    ap.add_argument("--local-keys", type=Path, help="offline JSON {domain: {selector: txt}}")
    args = ap.parse_args(argv)

    domains = list(args.domains)
    if args.domains_file:
        domains += [
            d.strip() for d in args.domains_file.read_text().splitlines() if d.strip()
        ]
    resolver = None
    if args.local_keys:
        from ..helpers.dns import parse_dkim_txt

        table = {}
        data = json.loads(args.local_keys.read_text())
        for dom, sels in data.items():
            for sel, txt in sels.items():
                parsed = parse_dkim_txt(txt)
                if parsed:
                    table[(dom, sel)] = [parsed]
        resolver = StaticResolver(table)

    crawled = crawl_domains(domains, resolver=resolver)
    payload = {"keys": crawled, "calls": registry_calldata(crawled)}
    args.output.write_text(json.dumps(payload, indent=2))
    print(f"wrote {args.output} with {sum(len(v) for v in crawled.values())} keys")


if __name__ == "__main__":
    main()
