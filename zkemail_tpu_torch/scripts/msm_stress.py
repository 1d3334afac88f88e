"""MSM stress harness: one CRS-scale batched MSM on synthetic data.

The port of ``zkemail_tpu/scripts/msm_stress.py``: it runs the bucket MSM
(``ops/msm.py::msm_multi``) or the sort MSM (``ops/msm_sort.py::
msm_sorted``, the prover's route) at the full640 EmailVerifier's call shape
(1,310,234 points, batch 4) on random coordinates and scalars, so that the
MSM can be timed and bisected without the witness:

    python -m zkemail_tpu_torch.scripts.msm_stress --n 1310234 --batch 4
    python -m zkemail_tpu_torch.scripts.msm_stress --kind g2 --algo sort
    python -m zkemail_tpu_torch.scripts.msm_stress --device cpu --n 64 --batch 1

Coordinates are random canonical limbs (below p): not curve points, but the
complete addition is branch-free, so the kernels run exactly as on the CRS.
The JAX script's ``--chunked`` (``msm_multi_chunked``, a bucket MSM cut into
dispatches that each stay under the TPU's per-program watchdog) and its sort
``--rows`` (the port's ``msm_sorted`` takes every row in one call) have no
counterpart. Prints one JSON line, metric ``msm_stress_s``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core import curve_torch as CT
from ..core import field as F
from ..device import resolve_device
from ..ops.msm import msm_multi
from ..ops.msm_sort import msm_sorted

L = F.LIMBS


def random_limbs(rng, shape) -> np.ndarray:
    """Random 12-bit limbs with the top limb below 3: values below 2^253,
    canonical in Fq and in Fr."""
    x = rng.integers(0, F.LIMB_MASK + 1, size=(L,) + tuple(shape), dtype=np.int32)
    x[L - 1] %= 3
    return x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="MSM stress harness")
    ap.add_argument("--n", type=int, default=1310234, help="point count")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kind", choices=["g1", "g2"], default="g1")
    ap.add_argument("--threads", type=int, default=0, help="bucket T override (0 = auto)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cbits", type=int, default=8, help="bucket window bits")
    ap.add_argument("--algo", choices=["bucket", "sort"], default="bucket",
                    help="sort = the prover's sort/telescope MSM")
    ap.add_argument("--cols", type=int, default=0,
                    help="sort path column width override (0 = default)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    n, bsz = args.n, args.batch
    print(f"# device={dev} kind={args.kind} algo={args.algo} n={n} batch={bsz}",
          file=sys.stderr, flush=True)

    def coord():
        return torch.from_numpy(random_limbs(rng, (n,))).to(dev)

    if args.kind == "g1":
        ops = CT.FQ_OPS
        pts = {k: coord() for k in ("x", "y", "z")}
    else:
        ops = CT.FQ2_OPS
        pts = {k: (coord(), coord()) for k in ("x", "y", "z")}
    scal = torch.from_numpy(random_limbs(rng, (bsz, n))).to(dev)

    if args.algo == "sort":
        def fn():
            return msm_sorted(ops, pts, scal, col_chunk=args.cols)
    else:
        def fn():
            return msm_multi(ops, pts, scal, c_bits=args.cbits, threads=args.threads)

    def timed():
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def checksum(out) -> int:
        x = out["x"][0] if isinstance(out["x"], tuple) else out["x"]
        return int(x.to(torch.int64).sum()) & 0xFFFFFFFF

    out, first_s = timed()
    print(f"# first call (kernel build + run) {first_s:.1f}s", file=sys.stderr, flush=True)
    times = []
    for i in range(args.reps):
        out, t = timed()
        times.append(t)
        print(f"# rep {i} {t:.3f}s", file=sys.stderr, flush=True)
    line = {
        "metric": "msm_stress_s",
        "value": min(times),
        "unit": "s/call",
        "detail": {
            "kind": args.kind, "n": n, "batch": bsz,
            "compile_s": first_s,
            "times": times,
            "out_checksum": checksum(out),
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
