"""Bridge: host-pipeline CircuitInput dicts -> witness-evaluator tensors.

The port of ``zkemail_tpu/models/input_bridge.py``. Takes the string-array
dicts produced by ``helpers.input_gen.generate_email_verifier_inputs``
(reference CircuitInput shape, input-generators.ts:6-19), batches them,
attaches the RSA advice hints (computed on the host, ``circuits/advice.py``)
and emits the {name: tensor} mapping the compiled circuit consumes, on the
witness device (CUDA unless the caller passes device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuits.advice import rsa_advice, stack_advice
from ..core import limbs as LB
from ..device import resolve_device
from ..helpers.binary_format import chunks_to_big_int
from .email_verifier import EmailVerifierConfig


def prepare_inputs(batch_inputs: list[dict], cfg: EmailVerifierConfig, device=None) -> dict:
    """List of per-email CircuitInput dicts -> input tensors on `device`
    (trailing batch axis): int32 values for byte and length inputs, (L, …)
    int32 limbs for field inputs."""
    dev = resolve_device(device)
    b = len(batch_inputs)

    def u32_field(name, length=None):
        if length is None:
            return np.array([int(x[name]) for x in batch_inputs], dtype=np.int32)
        arr = np.zeros((length, b), dtype=np.int32)
        for j, x in enumerate(batch_inputs):
            col = np.array([int(v) for v in x[name]], dtype=np.int64)
            arr[: len(col), j] = col
        return arr

    def fr_field(name, k=17):
        arr = np.zeros((k, b), dtype=object)
        for j, x in enumerate(batch_inputs):
            for i in range(k):
                arr[i, j] = int(x[name][i])
        return LB.ints_to_limbs(arr)

    out = {
        "emailHeader": u32_field("emailHeader", cfg.max_headers_length),
        "emailHeaderLength": u32_field("emailHeaderLength"),
        "pubkey": fr_field("pubkey"),
        "signature": fr_field("signature"),
    }
    if not cfg.ignore_body_hash_check:
        out["emailBody"] = u32_field("emailBody", cfg.max_body_length)
        out["emailBodyLength"] = u32_field("emailBodyLength")
        out["bodyHashIndex"] = u32_field("bodyHashIndex")
        out["precomputedSHA"] = u32_field("precomputedSHA", 32)
        if cfg.remove_soft_line_breaks:
            out["decodedEmailBodyIn"] = u32_field("decodedEmailBodyIn", cfg.max_body_length)
    if cfg.enable_header_masking:
        out["headerMask"] = u32_field("headerMask", cfg.max_headers_length)
    if cfg.enable_body_masking:
        out["bodyMask"] = u32_field("bodyMask", cfg.max_body_length)

    # RSA long-division advice per email
    advs = []
    for x in batch_inputs:
        sig = chunks_to_big_int([int(v) for v in x["signature"]], 121)
        mod = chunks_to_big_int([int(v) for v in x["pubkey"]], 121)
        advs.append(rsa_advice(sig, mod))
    out.update(stack_advice(advs))
    return {k: torch.as_tensor(np.asarray(v, dtype=np.int32), device=dev)
            for k, v in out.items()}
