"""Benchmark subcircuits: the BASELINE.md config ladder below the full
EmailVerifier.

The reference publishes per-component constraint counts
(packages/circuits/email-verifier.circom:66 SHA-256 header ~506k, :86
RSA-2048 verify ~149k) and its docs benchmark the SHA / RSA subcircuits
separately before the full pipeline. These builders expose the same two
stages as standalone provable circuits for `bench.py`
(BENCH_CONFIG=sha640 / rsa2048), reusing the production gadgets unchanged.

The port of ``zkemail_tpu/models/subcircuits.py`` (the builders are numpy,
unchanged), with the input code that ``bench.py`` keeps for these configs
beside them: the benchmark's emails (``bench_emails``), the sha640 and
rsa2048 inputs (``subcircuit_inputs``, bench.py:138-190) and the reveal
window of full640reveal (``reveal_window``, bench.py:361-374), on the
port's signer, DKIM verify and advice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuits.advice import rsa_advice, stack_advice
from ..circuits.builder import ConstraintSystem
from ..circuits.gadgets.basic import num2bits
from ..circuits.gadgets.poseidon_gadget import poseidon_large
from ..circuits.gadgets.rsa import rsa_verifier_65537
from ..circuits.gadgets.sha_wrappers import pack_digest_hi_lo, sha256_bytes
from ..core import limbs as LB
from ..device import resolve_device
from ..helpers.binary_format import to_circom_bigint
from ..helpers.dkim import verify_dkim_signature
from ..helpers.sha_utils import sha256, sha256_pad


def build_sha_bench(max_len: int) -> ConstraintSystem:
    """Variable-length SHA-256 over a padded byte buffer, digest public.

    The header-hash stage of the EmailVerifier in isolation
    (email-verifier.circom:63-67): zero-padding assertion elided (no
    downstream consumer), digest packed hi/lo as the two public outputs."""
    cs = ConstraintSystem(f"sha_bench_{max_len}")
    data = cs.add_input("emailHeader", (max_len,))
    length = cs.add_input("emailHeaderLength", ())
    with cs.scope("sha256"):
        digest, _sha = sha256_bytes(cs, data, length)
        hi, lo = pack_digest_hi_lo(cs, digest)
    cs.mark_public(hi)
    cs.mark_public(lo)
    return cs


def build_rsa_bench() -> ConstraintSystem:
    """RSA-2048 (e=65537) PKCS1v15-SHA256 verify in isolation.

    The signature stage of the EmailVerifier (email-verifier.circom:87-95)
    with the digest as a bit-constrained INPUT instead of an in-circuit
    SHA, plus the Poseidon pubkey commitment as the public output
    (email-verifier.circom:173)."""
    cs = ConstraintSystem("rsa_bench")
    pubkey = cs.add_input("pubkey", (17,), dtype="fr")
    signature = cs.add_input("signature", (17,), dtype="fr")
    digest_bits = cs.add_input("digestBits", (8, 32))
    num2bits(cs, digest_bits, 1)  # boolean-constrain the digest input
    with cs.scope("rsa_verify"):
        rsa_verifier_65537(cs, signature, pubkey, digest_bits, ns="rsa")
    with cs.scope("pubkey_poseidon"):
        pk_hash = poseidon_large(cs, pubkey)
    cs.mark_public(pk_hash)
    hi, lo = pack_digest_hi_lo(cs, digest_bits)
    cs.mark_public(hi)
    cs.mark_public(lo)
    return cs


def build_email_reveal_bench(
    max_headers_length: int = 640,
    max_body_length: int = 768,
    max_reveal: int = 32,
) -> ConstraintSystem:
    """EmailVerifier + substring reveal — the BASELINE.md "EmailVerifier +
    regex reveal" benchmark config.

    The reference's application pattern (e.g. Proof-of-Twitter) composes
    EmailVerifier with RevealSubstring over the signed header
    (packages/circuits/helpers/reveal-substring.circom:13) and packs the
    revealed bytes as public signals (utils/regex.circom:62 PackRegexReveal
    role). Reveal window is bounds-checked against the header and packed
    31-bytes-per-field (PackBytes:28)."""
    from ..circuits.gadgets.bytes import pack_bytes
    from ..circuits.gadgets.email_helpers import reveal_substring
    from .email_verifier import EmailVerifierConfig, build_email_verifier

    cfg = EmailVerifierConfig(
        max_headers_length=max_headers_length,
        max_body_length=max_body_length,
        ignore_body_hash_check=False,
    )
    handles = build_email_verifier(cfg)
    cs = handles.cs
    header = next(b.signals for b in cs.input_bindings if b.name == "emailHeader")
    start = cs.add_input("revealStart", ())
    length = cs.add_input("revealLength", ())
    with cs.scope("reveal_substring"):
        sub = reveal_substring(cs, header, start, length, max_reveal)
        packed = pack_bytes(cs, sub)
    cs.mark_public(packed)
    return cs


def digest_to_bits(digest: bytes) -> np.ndarray:
    """SHA-256 digest -> the (8, 32) LSB-first word-bit layout sha256_bytes
    produces (sha_wrappers.sha256_bytes returns (8, 32) LSB-first bits)."""
    words = [
        int.from_bytes(digest[4 * i : 4 * i + 4], "big") for i in range(8)
    ]
    out = np.zeros((8, 32), dtype=np.int32)
    for i, w in enumerate(words):
        for j in range(32):
            out[i, j] = (w >> j) & 1
    return out


# bench.py's benchmark configs (bench.py:43-55), for the port's builders
CONFIGS = {
    # EmailVerifier family (kind=email)
    "nobody448": dict(kind="email", max_headers_length=448, max_body_length=192,
                      ignore_body_hash_check=True),
    "full640": dict(kind="email", max_headers_length=640, max_body_length=768,
                    ignore_body_hash_check=False),
    "full1024": dict(kind="email", max_headers_length=1024, max_body_length=1536,
                     ignore_body_hash_check=False),
    "full4kb": dict(kind="email", max_headers_length=1024, max_body_length=4096,
                    ignore_body_hash_check=False),
    # EmailVerifier + substring reveal
    "full640reveal": dict(kind="email_reveal", max_headers_length=640, max_body_length=768),
    # subcircuit ladder
    "sha640": dict(kind="sha", max_len=640),
    "rsa2048": dict(kind="rsa"),
}


def build_bench_circuit(spec: dict) -> ConstraintSystem:
    """The circuit of one CONFIGS entry, as bench.py builds it."""
    from .email_verifier import EmailVerifierConfig, build_email_verifier

    args = {k: v for k, v in spec.items() if k != "kind"}
    kind = spec["kind"]
    if kind == "email":
        return build_email_verifier(EmailVerifierConfig(**args)).cs
    if kind == "email_reveal":
        return build_email_reveal_bench(**args)
    if kind == "sha":
        return build_sha_bench(args["max_len"])
    if kind == "rsa":
        return build_rsa_bench()
    raise ValueError(f"unknown config kind {kind}")


def bench_emails(signer, batch: int) -> list[bytes]:
    """The benchmark's `batch` distinct emails, signed by `signer`
    (``helpers/testkit.py::LocalDKIMSigner``), as bench.py makes them."""
    return [
        signer.sign_email(subject=f"bench email {i}", body=f"benchmark body {i}\r\n".encode())
        for i in range(batch)
    ]


LONG_BODY_SLACK = 130  # bytes left free: the body's SHA-256 padding, with room


def long_body_email(signer, max_body_length: int, seed: int = 0) -> bytes:
    """One email signed by `signer` whose body fills most of a config's
    `max_body_length` (that less LONG_BODY_SLACK bytes), so that the body
    hash, the bh= regex and prepare_inputs run over real data and not over
    padding: lines of ten words drawn from a seeded generator, single
    spaces and no trailing whitespace, so that relaxed canonicalization
    leaves the body as it is."""
    rng = np.random.default_rng(seed)
    words = np.array(["proof", "email", "batch", "field", "curve", "domain", "witness",
                      "signal", "header", "body", "hash", "key"])
    size = max_body_length - LONG_BODY_SLACK
    lines, total = [], 0
    while total < size:
        line = " ".join(rng.choice(words, 10))
        lines.append(line)
        total += len(line) + 2
    body = "\r\n".join(lines).encode()[: size - 2].rstrip(b" ") + b"\r\n"
    return signer.sign_email(subject=f"long body {seed}", body=body)


def subcircuit_inputs(kind: str, spec: dict, batch: int, signer, device=None) -> dict:
    """Input tensors on `device` (default: CUDA) for the sha640 ("sha",
    spec["max_len"]) and rsa2048 ("rsa") subcircuit configs: `batch`
    self-signed emails, DKIM-verified on the host, stages split per
    subcircuit (bench.py:138-190)."""
    dev = resolve_device(device)
    results = [verify_dkim_signature(eml, signer.resolver()) for eml in bench_emails(signer, batch)]
    if kind == "sha":
        max_len = spec["max_len"]
        hdr = np.zeros((max_len, batch), dtype=np.int32)
        lens = np.zeros((batch,), dtype=np.int32)
        for j, res in enumerate(results):
            padded, plen = sha256_pad(res.headers, max_len)
            hdr[:, j] = np.frombuffer(padded, dtype=np.uint8)
            lens[j] = plen
        out = {"emailHeader": hdr, "emailHeaderLength": lens}
    elif kind == "rsa":
        # pubkey/signature limbs + the header digest as input bits
        pk = np.zeros((17, batch), dtype=object)
        sg = np.zeros((17, batch), dtype=object)
        bits = np.zeros((8, 32, batch), dtype=np.int32)
        advs = []
        for j, res in enumerate(results):
            n, _e = res.public_key
            pk[:, j] = [int(v) for v in to_circom_bigint(n)]
            sg[:, j] = [int(v) for v in to_circom_bigint(res.signature)]
            bits[:, :, j] = digest_to_bits(sha256(res.headers))
            advs.append(rsa_advice(res.signature, n))
        out = {"pubkey": LB.ints_to_limbs(pk), "signature": LB.ints_to_limbs(sg),
               "digestBits": bits, **stack_advice(advs)}
    else:
        raise ValueError(f"no subcircuit inputs for kind {kind!r}")
    return {k: torch.as_tensor(np.asarray(v, dtype=np.int32), device=dev) for k, v in out.items()}


def reveal_window(raws: list[dict], device=None) -> dict:
    """revealStart / revealLength of full640reveal (bench.py:361-374): the
    canonicalized ``subject:bench email {i}`` inside each email's signed
    header (the CircuitInput dicts of the batch, in bench_emails' order)."""
    dev = resolve_device(device)
    starts, lengths = [], []
    for i, raw in enumerate(raws):
        hdr = bytes(int(v) for v in raw["emailHeader"])
        needle = f"subject:bench email {i}".encode()
        pos = hdr.find(needle)
        if pos < 0:
            raise ValueError(f"email {i}: subject not found in the canonicalized header")
        starts.append(pos)
        lengths.append(len(needle))
    return {"revealStart": torch.tensor(starts, dtype=torch.int32, device=dev),
            "revealLength": torch.tensor(lengths, dtype=torch.int32, device=dev)}
