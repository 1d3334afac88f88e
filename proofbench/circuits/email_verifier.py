"""The EmailVerifier (zk-email-verify's email-verifier.circom) at a
configuration's sizes: the circuit the benchmark proves, and the window's
host inputs for it (DKIM verification, input generation, the bridge to
the witness's tensors), all the program's own."""

from __future__ import annotations

from zkemail_tpu_torch.helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from zkemail_tpu_torch.models.email_verifier import EmailVerifierConfig, build_email_verifier
from zkemail_tpu_torch.models.input_bridge import prepare_inputs


def _verifier_config(cfg: dict) -> EmailVerifierConfig:
    return EmailVerifierConfig(max_headers_length=cfg["max_headers_length"],
                               max_body_length=cfg["max_body_length"],
                               ignore_body_hash_check=cfg["ignore_body_hash_check"])


def build(cfg: dict):
    """The compiled circuit (the program's CompiledCircuit)."""
    return build_email_verifier(_verifier_config(cfg)).cs.compile()


def fits(cfg: dict, header_padded: int, body_padded: int) -> bool:
    return (header_padded <= cfg["max_headers_length"]
            and body_padded <= cfg["max_body_length"])


def host_inputs(raws: list[bytes], resolver, cfg: dict, device) -> dict:
    """One batch of emails -> the witness's input tensors on `device`."""
    args = InputGenArgs(max_headers_length=cfg["max_headers_length"],
                        max_body_length=cfg["max_body_length"],
                        ignore_body_hash_check=cfg["ignore_body_hash_check"])
    batch = [generate_email_verifier_inputs(raw, resolver, args) for raw in raws]
    return prepare_inputs(batch, _verifier_config(cfg), device=device)
