"""The readings that the limits of ``correct`` are set from, in one process:
one set-up, then a short window for each seed (the cell's own batch and
sizes), each judged as a run judges it; then the control on its seeds.

    python3 proofbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 91,92,93 [--seconds 1]

The control breaks a guarantee the configuration states: every proof
attests a witness that satisfies the circuit. It proves, through the
program's own ``prove_batch``, witnesses whose first private signal (the
first header byte, under the header hash the proof publishes) was changed
by one. A sound check reads ``proofs_rejected`` above 0 for it. The
benchmark's own runs never run this. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from proofbench import harness as H  # noqa: E402
from proofbench.reference import judge as J  # noqa: E402
from proofbench.signer import load_keys  # noqa: E402
from proofbench.traffic import Traffic  # noqa: E402


def tampered(prove):
    """prove, on a copy of the witness with its first private signal + 1."""
    def run(pk, cc, w, rng, timers, device, mesh):
        w = w.clone()
        w[0, cc.n_public + 1, :] ^= 1
        return prove(pk, cc, w, rng, timers, device, mesh)
    return run


def readings(rank: H.Rank, seed: int) -> dict:
    """One short window of `seed` on an already set-up rank, judged."""
    rank.traffic = Traffic(rank.mix, seed, load_keys())
    rank.rng = random.Random(f"proofbench-prove:{seed}")
    rank.next, rank.batches, rank.seed = rank.batch_size, [], seed
    rank.traced = None
    rank.window()
    done = rank.batches
    emails = [rank.traffic.email(b["first"] + j) for b in done for j in range(b["requests"])]
    t = time.perf_counter()
    checks = J.judge(H.statement(rank.cc, rank.cfg["setup_seed"]), rank.cfg["publics"],
                     emails, [a for b in done for a in b["answers"]], seed,
                     ((0,), (0,)))
    checks.pop("bad")
    checks.pop("circuit_size_off")
    return {"seed": seed, "requests": len(emails), "window_s": rank.window_s,
            "judge_s": time.perf_counter() - t, **checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((H.REPO / "BENCHMARK.json").read_text())
    spec = H.cell_spec(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rank = H.Rank(spec, seeds[0], args.seconds, False, args.device, time.time())
    rank.setup()
    for seed in seeds:
        print(json.dumps({"kind": "program", **readings(rank, seed)}), flush=True)
    prove = H._prove
    H._prove = tampered(prove)
    try:
        for seed in (int(s) for s in args.control_seeds.split(",")):
            print(json.dumps({"kind": "control", **readings(rank, seed)}), flush=True)
    finally:
        H._prove = prove
    return 0


if __name__ == "__main__":
    sys.exit(main())
