"""The prover's sort route against the bucket msm_multi, on one proving key.

prove_batch proves by the sort route (ops/msm_sort.py). The bucket route,
every MSM through ops/msm.py::msm_multi (the JAX package's CPU route), is
the reference it is held to: bucket_points below, which chip_smoke.py
calls too.

As a script: builds a synthetic R1CS (synthetic_r1cs.py) of the given
dimensions, runs setup on the device, then prove_points and bucket_points
in turn (sort, bucket, sort, bucket, ... for --pairs pairs) on the same
witnesses, checks that every run gives the same five pre-blinding points,
and prints the wall time and stage timers of each run as one JSON line
(the first sort run also builds the key's signal plan). On CUDA the line
carries the card's name and power limit.

    python -m zkemail_tpu_torch.scripts.msm_routes
    python -m zkemail_tpu_torch.scripts.msm_routes --device cpu \\
        --n-constraints 30 --n-signals 28
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..core import curve_torch as CT
from ..core import limbs as LB
from ..device import resolve_device
from ..ops.msm import msm_multi
from ..prover import groth16 as G
from ..prover.setup import groth16_setup
from .synthetic_r1cs import make_circuit


def bucket_points(pk, cc, witnesses: torch.Tensor, timers: dict | None = None):
    """prove_points with every MSM through the bucket msm_multi: the same
    scalars (the c MSM over the non-public signals against the unpadded c
    query), the same host point lists (a, b2, b1, c, h), the same stage
    timers without plan."""
    mark = G._marker(pk, timers)
    h_t, w_t = G.msm_scalars(pk, cc, witnesses)
    mark("h_stage_s")
    out = {"h": msm_multi(CT.FQ_OPS, pk.h_query, h_t)}
    mark("msm_h_s")
    for name in ("a", "b2", "b1", "c"):
        ops = CT.FQ2_OPS if name == "b2" else CT.FQ_OPS
        scal = w_t[:, :, pk.n_public + 1 :] if name == "c" else w_t
        out[name] = msm_multi(ops, getattr(pk, G.SIGNAL_MSMS[name]), scal)
        mark(f"msm_{name}_s")
    return G._results_to_host(out["a"], out["b2"], out["b1"], out["c"], out["h"],
                              witnesses.shape[2])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-constraints", type=int, default=1_351_641)
    ap.add_argument("--n-signals", type=int, default=1_310_234)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    out = {"device": str(dev), "n_constraints": args.n_constraints,
           "n_signals": args.n_signals, "batch": args.batch}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    else:
        out["torch_threads"] = torch.get_num_threads()
    circ = make_circuit(args.n_constraints, args.n_signals, seed=1)
    t0 = time.time()
    pk = groth16_setup(circ.r1cs, seed=3, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["setup_s"] = time.time() - t0
    w = LB.to_device(circ.witness(args.batch, seed=2), dev)
    runs, ref = [], None
    with torch.inference_mode():
        for route, fn in (("sort", G.prove_points), ("bucket", bucket_points)) * args.pairs:
            timers = {}
            t0 = time.time()
            points = fn(pk, circ.r1cs, w, timers)
            runs.append({"route": route, "wall_s": time.time() - t0, **timers})
            ref = ref or points
            if points != ref:
                raise AssertionError(f"the {route} route's points differ from the first run's")
    out["runs"] = runs
    print(json.dumps(out))


if __name__ == "__main__":
    main()
