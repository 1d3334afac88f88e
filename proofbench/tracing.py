"""Spans around the calls into the program's layers, and the reduction of
one profiled batch's device trace.

A span is the host's wall time of one call into a layer (inputs, witness,
prove). In a traced run each span is also a ``torch.profiler``
annotation and ends with a device synchronisation, so that its time is
the layer's own; an untimed run takes host times only (the batch ends on
the host anyway, when its proofs come back).

The profiled batch's trace is exported as Chrome JSON (to ``TMPDIR``,
deleted once read) and reduced to: the device's busy seconds (the union of
kernel, copy and set intervals), device time by operation, the idle
seconds by what the host was doing (the harness span, or within the prove
the stage that the program's own stage timers place there), and the K2
kernel's device seconds. The arithmetic of the busy share is that of
``zkemail_tpu_torch/scripts/prove_profile.py::device_summary``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import contextmanager

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROVE_STAGES = ("h_stage_s", "msm_h_s", "msm_a_s", "msm_b2_s", "msm_b1_s", "msm_c_s")
K2_NAME = "ec_add_g1"


class Spans:
    """Host seconds of the last call into each layer."""

    def __init__(self, device: torch.device, traced: bool):
        self.device, self.traced = device, traced
        self.last: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(f"pb.{name}"):
                yield
                self.sync()
        else:
            yield
        self.last[name] = time.perf_counter() - t0


def profile(fn):
    """(fn(), events) with fn run under torch.profiler (CPU and CUDA
    activities) inside a "pb.batch" annotation; events are the trace's
    annotations and device operations as (cat, name, start_us, dur_us)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("pb.batch"):
            out = fn()
    fd, path = tempfile.mkstemp(prefix="proofbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    events = [(e.get("cat"), e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
              for e in raw
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS + ("user_annotation",)]
    return out, events


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list, prove_timers: dict | None) -> dict:
    """The profiled batch's device summary (seconds): window_s, busy_s,
    device_ops {name: s}, idle {what the host was doing: s}, k2_s."""
    notes = {n: (t, t + d) for c, n, t, d in events
             if c == "user_annotation" and n.startswith("pb.")}
    w0, w1 = notes["pb.batch"]
    dev = [(n, max(t, w0), min(t + d, w1)) for c, n, t, d in events
           if c in DEVICE_CATS and t < w1 and t + d > w0]
    ops: dict[str, float] = {}
    for n, a, b in dev:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
    busy = _union([(a, b) for _, a, b in dev])
    regions = _host_regions(notes, prove_timers)
    idle: dict[str, float] = {}
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = (edge + a) / 2
            what = next((name for name, (r0, r1) in regions if r0 <= mid < r1), "harness")
            idle[what] = idle.get(what, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": ops,
        "idle": idle,
        "k2_s": sum(s for n, s in ops.items() if K2_NAME in n),
    }


def _host_regions(notes: dict, prove_timers: dict | None) -> list:
    """[(name, (start_us, end_us))]: the prove's stages first (placed by the
    program's stage timers from the prove span's start), then the spans."""
    regions = []
    if "pb.prove" in notes and prove_timers:
        t, end = notes["pb.prove"]
        for stage in PROVE_STAGES:
            if stage in prove_timers:
                t1 = t + prove_timers[stage] * 1e6
                regions.append((f"prove.{stage[:-2]}", (t, t1)))
                t = t1
        regions.append(("prove.blind", (t, end)))
    regions += [(n[3:], span) for n, span in notes.items() if n != "pb.batch"]
    return regions


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds]]."""
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
