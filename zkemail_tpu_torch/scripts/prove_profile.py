"""Where the time of one full-width prove_batch goes on the card.

Builds the synthetic R1CS of the full EmailVerifier's dimensions (as
chip_smoke.py), runs setup and one warm-up prove_batch at B = 2, then a
second prove_batch under torch.profiler, and prints: the stage timers, the
device time by kernel (the port's K1-K3 and PyTorch's own kernels), the
share of K1-K3, and the device's busy and idle share of the profiled wall
time. The full table goes to chiprun_out/prove_profile.txt.

    python -m zkemail_tpu_torch.scripts.prove_profile
"""

from __future__ import annotations

import json
import random
import subprocess
import time
from pathlib import Path

import torch

from ..prover.groth16 import prove_batch
from ..prover.setup import groth16_setup
from .synthetic_r1cs import make_circuit

FULL640 = {"n_constraints": 1_351_641, "n_signals": 1_310_234}
PORT_KERNELS = ("mont_mul_kernel", "ec_add_g1_kernel", "ec_add_g2_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("prove_profile needs a CUDA device")
    dev = torch.device("cuda")
    card = card_name()
    circ = make_circuit(FULL640["n_constraints"], FULL640["n_signals"], seed=1)
    w = circ.witness(2, seed=2)
    pk = groth16_setup(circ.r1cs, seed=3, device=dev)
    warm = {}
    prove_batch(pk, circ.r1cs, w, rng=random.Random(4), timers=warm, device=dev)
    timers = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        prove_batch(pk, circ.r1cs, w, rng=random.Random(4), timers=timers, device=dev)
        wall = time.time() - t0

    summary, lines = device_summary(prof, wall)
    summary = {"card": card, "warm_timers": warm, "timers": timers, **summary}
    write_profile("prove_profile.txt", summary, lines)


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_summary(prof, wall: float):
    """(summary, table lines) of a torch.profiler run over `wall` seconds:
    device time by kernel, the port's K1-K3 and their share, and the
    device's busy share of the wall time."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e6, ev.count))
    rows.sort(key=lambda r: -r[1])
    # kernels only: the profiler also lists the CPU-side op names, and CUPTI's
    # "Command Buffer Full" row (time the launch queue was full), no kernel
    kernel_rows = [r for r in rows
                   if not r[0].startswith("aten::") and r[0] != "Command Buffer Full"]
    device_s = sum(r[1] for r in kernel_rows)
    port_s = {k: sum(r[1] for r in kernel_rows if k in r[0]) for k in PORT_KERNELS}
    summary = {
        "profiled_wall_s": wall,
        "device_busy_s": device_s,
        "device_busy_share": device_s / wall,
        "kernel_launches": sum(r[2] for r in kernel_rows),
        "port_kernel_s": port_s,
        "port_kernel_share_of_device": sum(port_s.values()) / device_s if device_s else None,
        "top_kernels": [(k[:90], round(s, 4), n) for k, s, n in kernel_rows[:15]],
    }
    return summary, [f"{s:12.6f} s  {n:8d}  {k}" for k, s, n in kernel_rows]


def write_profile(name: str, summary: dict, lines: list) -> None:
    """The summary and the full table to chiprun_out/<name>; the summary to
    standard output as one JSON line."""
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(summary, indent=1) + "\n\n" + "\n".join(lines))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
