"""Primitive throughput microbenchmarks on the card.

The port of ``zkemail_tpu/scripts/prim_bench.py``, with the same list of
measurements: K1 (``mont_mul``), K2 (``ec_add_g1``, the doubling
``ec_double_g1``, a select-accumulate and a masked tree reduction), the
scatter-set, scatter-add and gather of k limb columns into a 2^17-column
table, and sorts of n int32 keys:

    python -m zkemail_tpu_torch.scripts.prim_bench --n 1048576
    python -m zkemail_tpu_torch.scripts.prim_bench --device cpu --n 256

Each measurement is the least of ``--reps`` timed calls after a warm call:
on the card CUDA events around the call's launches, queued behind a spin
kernel so that they time the device's work and not the host's launching;
on the CPU the host clock. Prints one JSON line {name: {"s": seconds per
call, "rate_per_s": work / s}}.
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
from ..core import limbs as LB
from ..device import resolve_device
from .msm_stress import random_limbs

L = F.LIMBS
SPIN_CYCLES = 20_000_000  # about 10 ms of the card's clock: longer than queueing a call


def seconds_per_call(fn, device: torch.device, reps: int) -> float:
    """The least of `reps` calls' seconds after one warm call: on the card
    CUDA events around each call, its launches queued behind a spin kernel;
    the host clock on the CPU."""
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="primitive microbenchmarks")
    ap.add_argument("--n", type=int, default=1 << 20, help="lane count")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n = args.n
    rng = np.random.default_rng(0)
    out = {}

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    def bench(name, fn, work=None):
        t = seconds_per_call(fn, dev, args.reps)
        rate = (work or n) / t
        out[name] = {"s": t, "rate_per_s": f"{rate:.3e}"}
        print(f"# {name}: {t * 1e3:8.4f} ms  ->  {rate:.3e} /s", file=sys.stderr, flush=True)

    a, b = tensor(random_limbs(rng, (n,))), tensor(random_limbs(rng, (n,)))
    bench("mont_mul", lambda: LB.mont_mul(LB.FQ_SPEC, a, b))

    pt = {k: tensor(random_limbs(rng, (n,))) for k in ("x", "y", "z")}
    pt2 = {k: tensor(random_limbs(rng, (n,))) for k in ("x", "y", "z")}
    bench("ec_add_g1", lambda: CT.ec_add(CT.FQ_OPS, pt, pt2))
    bench("ec_double_g1", lambda: CT.ec_double(CT.FQ_OPS, pt))

    # scatter-set, scatter-add and gather of k columns of a (L, 2^17) table,
    # as a bucket table's update
    m = 1 << 17
    for k in (1 << 14, 1 << 17):
        idx = tensor(rng.integers(0, m, size=k, dtype=np.int64))
        upd = tensor(rng.integers(0, F.LIMB_MASK + 1, size=(L, k), dtype=np.int32))
        tab = torch.zeros((L, m), dtype=torch.int32, device=dev)
        bench(f"scatter_set_k{k}", lambda: tab.index_copy(1, idx, upd), work=k)
        bench(f"scatter_add_k{k}", lambda: tab.index_add(1, idx, upd), work=k)
        bench(f"gather_k{k}", lambda: tab.index_select(1, idx), work=k)

    # select-accumulate: the addition kept on lanes where mask is 0
    mask = tensor(rng.integers(0, 2, size=n, dtype=np.int32) == 1)
    bench("ec_select_add_g1", lambda: CT.ec_select(
        CT.FQ_OPS, mask, pt, CT.ec_add(CT.FQ_OPS, pt, pt2)))

    # masked tree reduction over the point axis: log2(n) halving rounds
    def tree_reduce():
        q = CT.ec_select(CT.FQ_OPS, mask, pt, CT.ec_identity(CT.FQ_OPS, (n,), dev))
        nn = n
        while nn > 1:
            half = nn // 2
            q = CT.ec_add(CT.FQ_OPS, {k: v[:, :half] for k, v in q.items()},
                          {k: v[:, half : 2 * half] for k, v in q.items()})
            nn = half
        return q
    bench("ec_tree_reduce_g1", tree_reduce, work=n)

    keys = tensor(rng.integers(0, 1 << 20, size=n, dtype=np.int32))
    vals = tensor(rng.integers(0, 1 << 20, size=n, dtype=np.int32))
    bench("sort_i32", lambda: torch.sort(keys))
    bench("argsort_i32", lambda: torch.argsort(keys))

    def sort_kv():
        sk, order = torch.sort(keys)
        return sk, vals[order]
    bench("sort_kv_i32", sort_kv)

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
