"""A tiny circuit for the benchmark's own CPU tests: the DKIM-verified
header's SHA-256 digest as 256 input bits, each constrained boolean,
published as the EmailVerifier publishes it (two 128-bit halves, shaHi and
shaLo). 514 constraints on a 2^10 domain, so a whole run (set-up,
window, check) fits a CPU test, with the program's DKIM verification,
witness, setup and prover on the path."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from zkemail_tpu_torch.circuits.builder import ConstraintSystem
from zkemail_tpu_torch.circuits.gadgets.basic import num2bits
from zkemail_tpu_torch.circuits.gadgets.sha_wrappers import pack_digest_hi_lo
from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature


def build(cfg: dict):
    cs = ConstraintSystem("header_digest")
    bits = cs.add_input("digestBits", (8, 32))
    num2bits(cs, bits, 1)
    hi, lo = pack_digest_hi_lo(cs, bits)
    cs.mark_public(hi)
    cs.mark_public(lo)
    return cs.compile()


def fits(cfg: dict, header_padded: int, body_padded: int) -> bool:
    return True


def host_inputs(raws: list[bytes], resolver, cfg: dict, device) -> dict:
    """The digest's bits as (8 words, 32 bits LSB first, batch)."""
    bits = np.zeros((8, 32, len(raws)), dtype=np.int32)
    for j, raw in enumerate(raws):
        digest = hashlib.sha256(verify_dkim_signature(raw, resolver).headers).digest()
        words = np.frombuffer(digest, dtype=">u4").astype(np.int64)
        bits[:, :, j] = (words[:, None] >> np.arange(32)) & 1
    return {"digestBits": torch.as_tensor(bits, device=device)}
