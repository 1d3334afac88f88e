"""Constraint profiler — the `snarkjs r1cs info` role.

The port of ``zkemail_tpu/scripts/r1cs_info.py``. The upstream circuits
record per-component constraint counts by hand in circuit comments
(zk-email-verify packages/circuits/email-verifier.circom) after running
`snarkjs r1cs info` out-of-band. Here the builder tracks constraint/signal
spans per named scope at build time, so the breakdown is a first-class
artifact (the build is numpy on the host; no device is used):

    python -m zkemail_tpu_torch.scripts.r1cs_info --config full640

prints a per-component table plus totals, and `--json` emits a machine-
readable line for dashboards.
"""

from __future__ import annotations

import argparse
import json

CONFIGS = {
    "nobody448": dict(max_headers_length=448, max_body_length=192, ignore_body_hash_check=True),
    "full640": dict(max_headers_length=640, max_body_length=768, ignore_body_hash_check=False),
    "full1024": dict(max_headers_length=1024, max_body_length=1536, ignore_body_hash_check=False),
}


def scope_report(cc) -> list[dict]:
    """Per-scope constraint/signal counts, nested scopes reported as paths.

    `constraints`/`signals` are INCLUSIVE spans (everything emitted while
    the scope was open, children included); `self_constraints` subtracts
    the direct children's inclusive spans, so the self column sums to the
    circuit total without double counting.
    """
    rows = []
    for path, c0, c1, s0, s1 in cc.scopes:
        child_c = sum(
            cc1 - cc0
            for p2, cc0, cc1, _, _ in cc.scopes
            if p2.startswith(path + "/") and "/" not in p2[len(path) + 1 :]
        )
        rows.append(
            {
                "scope": path,
                "constraints": c1 - c0,
                "self_constraints": (c1 - c0) - child_c,
                "signals": s1 - s0,
            }
        )
    labeled = sum(r["constraints"] for r in rows if "/" not in r["scope"])
    rows.append(
        {
            "scope": "(unlabeled)",
            "constraints": cc.n_constraints - labeled,
            "self_constraints": cc.n_constraints - labeled,
            "signals": None,
        }
    )
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="R1CS constraint breakdown")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="full640")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from ..models.email_verifier import EmailVerifierConfig, build_email_verifier

    cfg = EmailVerifierConfig(**CONFIGS[args.config])
    handles = build_email_verifier(cfg)
    cc = handles.cs.compile()
    rows = scope_report(cc)

    if args.json:
        print(
            json.dumps(
                {
                    "config": args.config,
                    "n_constraints": cc.n_constraints,
                    "n_signals": cc.n_signals,
                    "n_public": cc.n_public,
                    "scopes": rows,
                }
            )
        )
        return

    print(f"config={args.config}  constraints={cc.n_constraints:,}  "
          f"signals={cc.n_signals:,}  public={cc.n_public}")
    print(f"{'scope':<32}{'incl':>14}{'self':>14}{'signals':>12}")
    for r in rows:
        sig = "" if r["signals"] is None else f"{r['signals']:,}"
        print(
            f"{r['scope']:<32}{r['constraints']:>14,}"
            f"{r['self_constraints']:>14,}{sig:>12}"
        )


if __name__ == "__main__":
    main()
