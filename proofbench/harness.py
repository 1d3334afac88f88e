"""proofbench: the benchmark of zkemail_tpu_torch, the PyTorch and CUDA
prover.

    python3 proofbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run, for one cell of ``BENCHMARK.json`` (a configuration under a traffic
mix):

1. set-up (``setup_s``, from the process's start to the first timed
   batch): the kernel library, the circuit built and compiled, the
   traffic signed from the seed, ``groth16_setup`` on the card (the
   matrices' first upload included; no key from disk), and one warm-up
   batch through the window's path;
2. the window: a closed loop of batches until ``--seconds`` have passed
   (the batch running at the deadline is finished), each batch: DKIM
   verification and input generation for each email, the input bridge,
   ``eval_witness`` and ``prove_batch`` under a ``random.Random`` seeded
   from ``--seed``. The port has no single entry from emails to proofs:
   these four calls are the window's entry;
3. with ``--trace 1``: one more batch under ``torch.profiler``;
4. the check (``reference/judge.py``), after the peak memory is read and
   the program's state freed: every proof after set-up against the
   reference's publics and verifying key;
5. one JSON line to standard output, the compared numbers with their
   limits as the last lines of standard error.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``circuits/<circuit>.py`` and
``metrics/<metric>.py`` (or ``metrics/<quantity>.py``, the metric's name
up to its first dot). A configuration that names a ``mesh`` [dp, msm]
runs on dp * msm ranks through ``zkemail_tpu_torch.parallel.launch.spawn``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

from . import roofline, tracing
from .reference import judge as J
from .signer import load_keys
from .traffic import Traffic, load_mix, sha_padded

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zkemail_tpu"}
WINDOW_BATCHES_MIN = 4  # emails signed before the window: at least this many batches


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str, root: Path = HERE) -> dict:
    """The cell's entry, configuration, mix and the metrics it reports; root
    holds the traffic/, circuits/ and metrics/ files (a configuration's
    file is relative to the repository)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]
    return {"cell": cell, "config": json.loads((REPO / conf["file"]).read_text()),
            "mix": load_mix(root, cell["traffic"]), "end_to_end": e2e, "per_layer": layer,
            "root": root}


def reader(name: str, root: Path = HERE):
    """metrics/<name>.py, else metrics/<name up to its first dot>.py."""
    for stem in (name, name.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_file_module(path, f"proofbench_metric_{stem.replace('.', '_')}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {root / 'metrics'}")


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def _prove(pk, cc, w, rng, timers, device, mesh):
    """The prove entry of the window (the call the fault tests replace)."""
    from zkemail_tpu_torch.prover.groth16 import prove_batch

    return prove_batch(pk, cc, w, rng=rng, timers=timers, device=device, mesh=mesh)


def _resolver(keys: list[dict]):
    from zkemail_tpu_torch.helpers.dns import StaticResolver

    return StaticResolver({(k["domain"], k["selector"]): [(k["n"], 65537)] for k in keys})


def _answer(proof, publics) -> dict:
    """A proof as plain ints for the reference."""
    def g1(p):
        return (int(p.x), int(p.y), bool(p.inf))

    b = proof.b
    return {"publics": [int(x) for x in publics], "a": g1(proof.a), "c": g1(proof.c),
            "b": ((int(b.x.c0), int(b.x.c1)), (int(b.y.c0), int(b.y.c1)), bool(b.inf))}


@contextmanager
def lane_counter():
    """{kernel: lanes} of the port's kernel launches inside the block (each
    launcher's lane count is its second last argument)."""
    from zkemail_tpu_torch.ops import field_kernels as FK

    launch, lanes = FK._launch, {}

    def counting(name, device, fn, *args):
        launch(name, device, fn, *args)
        lanes[name] = lanes.get(name, 0) + int(args[-2])

    FK._launch = counting
    try:
        yield lanes
    finally:
        FK._launch = launch


def statement(cc, setup_seed: int) -> dict:
    """What the reference needs of the R1CS: its sizes and the entries of
    its public columns (the constant one and the n_public publics)."""
    out = {"setup_seed": setup_seed, "n_constraints": int(cc.n_constraints),
           "n_public": int(cc.n_public), "entries": {}}
    for which in ("A", "B", "C"):
        rows, cols, cfs = getattr(cc, which)
        idx = (cols <= cc.n_public).nonzero()[0]
        out["entries"][which] = list(zip(rows[idx].tolist(), cols[idx].tolist(),
                                         [int(c) for c in cfs[idx]]))
    return out


def shapes(cc, log_m: int) -> dict:
    import numpy as np

    return {"log_m": log_m, "n_signals": int(cc.n_signals),
            "nnz_A": int(cc.A[0].size), "nnz_B": int(cc.B[0].size),
            "rows_A": int(np.unique(cc.A[0]).size), "rows_B": int(np.unique(cc.B[0]).size)}


class Phases:
    """Logs each set-up phase's seconds to standard error."""

    def __init__(self, t_start: float):
        self.t = t_start

    def __call__(self, what: str) -> None:
        now = time.time()
        print(f"proofbench: {now - self.t:8.3f} s  {what}", file=sys.stderr, flush=True)
        self.t = now


class Rank:
    """One process's run of a cell: set-up, window, traced batch."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float, mesh=None):
        import torch

        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.mesh = torch.device(device), t_start, mesh
        self.cfg, self.mix = spec["config"], spec["mix"]
        self.circuit = load_file_module(spec["root"] / "circuits" / f"{self.cfg['circuit']}.py",
                                        f"proofbench_circuit_{self.cfg['circuit']}")
        self.spans = tracing.Spans(self.device, trace)

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from zkemail_tpu_torch.ops import kernel_build
        from zkemail_tpu_torch.prover.setup import groth16_setup

        torch.set_grad_enabled(False)
        log = Phases(self.t_start)
        if self.device.type == "cuda":
            kernel_build.library()
        log("imports and kernel library")
        self.cc = self.circuit.build(self.cfg)
        log("circuit built and compiled")
        keys = load_keys()
        self.resolver = _resolver(keys)
        self.traffic = Traffic(self.mix, self.seed, keys)
        self.batch_size = self.traffic.batch
        self.pk = groth16_setup(self.cc, self.cfg["setup_seed"], device=self.device)
        log("groth16_setup (the matrices' first upload included)")
        self.rng = random.Random(f"proofbench-prove:{self.seed}")
        self.next = 0
        t = time.perf_counter()
        self.run_batch()  # warm-up: the witness's constants, the signal plan
        warm_s = time.perf_counter() - t
        log("warm-up batch")
        need = max(WINDOW_BATCHES_MIN, math.ceil(2 * self.seconds / warm_s) + 2)
        for i in range(self.next + need * self.batch_size):
            e = self.traffic.email(i)
            if not self.circuit.fits(self.cfg, sha_padded(e["header_bytes"]),
                                     sha_padded(e["body_bytes"])):
                raise ValueError(f"email {i} does not fit {self.cfg['name']}: "
                                 f"header {e['header_bytes']} B, body {e['body_bytes']} B")
        log(f"{self.traffic.signed()} emails signed")
        self.setup_peak = self._peak()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.batches: list[dict] = []
        self.traced: dict | None = None

    def _peak(self) -> int | None:
        import torch

        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)

    # -- one batch ------------------------------------------------------------
    def run_batch(self) -> dict:
        from zkemail_tpu_torch.ops import field_kernels as FK

        first = self.next
        emails = [self.traffic.email(i) for i in range(first, first + self.batch_size)]
        self.next += self.batch_size
        rec = {"first": first, "requests": len(emails), "t0": time.perf_counter()}
        try:
            with self.spans.span("inputs"):
                inputs = self.circuit.host_inputs([e["raw"] for e in emails], self.resolver,
                                                  self.cfg, self.device)
            k1 = FK.LAUNCHES["mont_mul"]
            with self.spans.span("witness"):
                w = self.cc.eval_witness(inputs, len(emails), device=self.device)
            rec["k1_witness"] = FK.LAUNCHES["mont_mul"] - k1
            timers = {} if self.trace else None
            with self.spans.span("prove"):
                proofs = _prove(self.pk, self.cc, w, self.rng, timers, self.device, self.mesh)
            rec["answers"] = [_answer(p, pub) for p, pub in proofs]
            rec["timers"] = timers
            rec["spans"] = dict(self.spans.last)
        except Exception:  # a failed batch leaves its requests unanswered
            traceback.print_exc(file=sys.stderr)
            rec["answers"] = [None] * len(emails)
            rec["failed"] = True
        rec["t1"] = time.perf_counter()
        return rec

    # -- the window -----------------------------------------------------------
    def window(self) -> None:
        t0 = time.perf_counter()
        self.setup_s = time.time() - self.t_start
        deadline = t0 + self.seconds
        while True:
            self.batches.append(self.run_batch())
            if self._stop(time.perf_counter() >= deadline):
                break
        self.window_s = time.perf_counter() - t0
        self.window_peak = self._peak()

    def _stop(self, local: bool) -> bool:
        """Rank 0's decision, on every rank of a mesh."""
        if self.mesh is None:
            return local
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(local)], device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def traced_batch(self) -> None:
        with lane_counter() as lanes:
            rec, events = tracing.profile(self.run_batch)
        summary = tracing.reduce_trace(events, rec.get("timers"))
        summary["k2_lanes"] = lanes.get("ec_add_g1", 0)
        rec["trace"] = summary
        self.traced = rec

    # -- what the process hands on --------------------------------------------
    def record(self, free: bool = True) -> dict:
        """The run's record for the result; with `free`, the key and the
        circuit are dropped and the device's cache emptied, so that the
        check runs without the program's state."""
        import torch

        traced = self.traced
        done = self.batches + ([traced] if traced else [])
        peaks = [p for p in (self.setup_peak, self.window_peak, self._peak()) if p is not None]
        out = {
            "setup_s": self.setup_s, "window_s": self.window_s,
            "batches": [{k: v for k, v in b.items() if k != "answers"} for b in self.batches],
            "traced": ({k: v for k, v in traced.items() if k != "answers"} if traced else None),
            "window_peak_bytes": self.window_peak,
            "memory_peak_bytes": max(peaks) if peaks else 0,
            "emails": [{"modulus": self.traffic.email(b["first"] + j)["modulus"],
                        "header_digest": self.traffic.email(b["first"] + j)["header_digest"]}
                       for b in done for j in range(b["requests"])],
            "answers": [a for b in done for a in b["answers"]],
            "circuit_size": ((int(self.cc.n_constraints), int(self.cc.n_signals),
                              int(self.pk.domain_log2)),
                             (self.cfg["n_constraints"], self.cfg["n_signals"],
                              self.cfg["domain_log2"])),
            "statement": statement(self.cc, self.cfg["setup_seed"]),
            "shapes": shapes(self.cc, self.pk.domain_log2),
        }
        if self.device.type == "cuda":
            out["device_kind"] = torch.cuda.get_device_name(self.device)
            if self.trace:
                out["peaks"] = roofline.card_peaks(self.device)
        if free:
            del self.pk, self.cc
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return out


def run_rank(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             mesh=None) -> dict:
    rank = Rank(spec, seed, seconds, trace, device, t_start, mesh)
    rank.setup()
    rank.window()
    if trace:
        rank.traced_batch()
    return rank.record()


def mesh_rank(rank: int, world: int, spec: dict, seed: int, seconds: float, trace: bool,
              device_type: str, t_start: float) -> dict:
    """One rank of a mesh cell (the body ``spawn`` runs in each child)."""
    import torch
    from zkemail_tpu_torch.parallel.sharding import make_mesh

    dp, _ = spec["config"]["mesh"]
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    mesh = make_mesh(world, dp=dp, device_type=dev.type,
                     backend="nccl" if dev.type == "cuda" else "gloo")
    return run_rank(spec, seed, seconds, trace, dev, t_start, mesh)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> list[dict]:
    """Every rank's record (one rank unless the configuration names a mesh)."""
    mesh = spec["config"].get("mesh")
    if not mesh:
        return [run_rank(spec, seed, seconds, trace, device, t_start)]
    from zkemail_tpu_torch.parallel.launch import spawn

    world = mesh[0] * mesh[1]
    return spawn(mesh_rank, world, backend="nccl" if device == "cuda" else "gloo",
                 args=(spec, seed, seconds, trace, device, t_start), timeout_s=340.0)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def result(spec: dict, recs: list[dict], seed: int, trace: bool, chips: int) -> dict:
    run = dict(recs[0])
    run["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in recs)
    t = time.perf_counter()
    checks = J.judge(run["statement"], spec["config"]["publics"], run["emails"],
                     run["answers"], seed, run["circuit_size"])
    print(f"proofbench: {time.perf_counter() - t:8.3f} s  the reference's check of "
          f"{len(run['answers'])} proofs", file=sys.stderr, flush=True)
    bad = checks.pop("bad")
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in names:
        value = reader(m["name"], spec["root"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if "device_kind" in run else "cpu",
              "kind": run.get("device_kind", "cpu"), "count": chips,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": len(run["answers"]) > 0 and all(
               checks[k] <= J.LIMITS[k] for k in J.LIMITS),
           "attempted": len(run["answers"]), "failed": len(bad),
           "metrics": metrics, "device": device}
    if trace and run.get("traced"):
        tr = run["traced"]["trace"]
        device["busy_s"] = sum(r["traced"]["trace"]["busy_s"] for r in recs) / len(recs)
        device["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tracing.top(tr["device_ops"]),
                            "idle_gaps": tracing.top(tr["idle"])}
    out["checks"] = {k: {"value": v, "limit": J.LIMITS[k]} for k, v in checks.items()}
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv: list[str] | None = None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="proofbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"proofbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    recs = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    out = result(spec, recs, args.seed, bool(args.trace), chips)
    loaded = forbidden_modules()
    if loaded:
        print(f"proofbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0
