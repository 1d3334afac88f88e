"""Where the time of one full640 email witness goes on the card.

Builds the EmailVerifier at full640 (header 640, body 768), signs B = 2
emails with the port's seeded signer, verifies DKIM and prepares the inputs
on the card, runs the witness once to move its constants there, times two
warm runs, takes the seconds by step kind (the device synchronized after
each step), then profiles one more run under torch.profiler and prints:
the times, the host syncs, K1's launches, the device time by kernel and the
device's busy and idle share of the profiled wall time. The full table goes
to chiprun_out/witness_profile.txt.

    python -m zkemail_tpu_torch.scripts.witness_profile
"""

from __future__ import annotations

import time

import torch

from ..helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
from ..helpers.testkit import LocalDKIMSigner
from ..models.email_verifier import EmailVerifierConfig, build_email_verifier
from ..models.input_bridge import prepare_inputs
from ..ops import field_kernels as FK
from .prove_profile import card_name, device_summary, write_profile

BATCH = 2


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("witness_profile needs a CUDA device")
    dev = torch.device("cuda")
    cfg = EmailVerifierConfig(max_headers_length=640, max_body_length=768)
    cc = build_email_verifier(cfg).cs.compile()
    signer = LocalDKIMSigner(seed=2026)
    emails = [signer.sign_email(subject=f"Profiled email {i}") for i in range(BATCH)]
    args = InputGenArgs(max_headers_length=640, max_body_length=768)
    raws = [generate_email_verifier_inputs(e, signer.resolver(), args) for e in emails]
    inputs = prepare_inputs(raws, cfg, device=dev)

    def run(stats=None) -> float:
        torch.cuda.synchronize()
        t0 = time.time()
        cc.eval_witness(inputs, BATCH, device=dev, stats=stats)
        torch.cuda.synchronize()
        return time.time() - t0

    cold = run()
    FK.reset_launches()
    warm = [run(), run()]
    launches = {k: v // 2 for k, v in FK.LAUNCHES.items()}
    stats = {}
    run(stats)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = run()
    summary, lines = device_summary(prof, wall)
    summary = {
        "card": card_name(),
        "n_signals": cc.n_signals,
        "witness_steps": len(cc.steps),
        "cold_s": cold,
        "warm_s": warm,
        "ms_per_email": [t / BATCH * 1e3 for t in warm],
        "launches": launches,
        "host_syncs": stats["syncs"],
        "steps_s": dict(sorted(stats["steps_s"].items(), key=lambda kv: -kv[1])),
        **summary,
    }
    write_profile("witness_profile.txt", summary, lines)


if __name__ == "__main__":
    main()
