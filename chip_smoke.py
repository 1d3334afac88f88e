#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkemail_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the kernels from zkemail_tpu_torch/ops/csrc at first use, then:

  1. card and build: the card's name and power limit, versions, build time
     and what ptxas reported for each kernel;
  2. each kernel against its plain PyTorch version on the card, exactly:
     K1 mont_mul (Fq and Fr, 2^20 lanes, with 0, 1 and p - 1; then at the
     witness's widths and at phase 9's Poseidon widths, up to 6,553,600
     lanes), K2 ec_add_g1
     (2^18 lanes) and K3 ec_add_g2 (2^16 lanes) with identity operands,
     P + P, P + (-P), negated lanes and coordinates 0 and p - 1; K2 and K3
     again at the widths the two MSM routes launch them at (the sort
     route's level-1 scans of the full-width h and dense b2 MSMs, its
     threshold terms, its per-row final scans, the bucket route's running
     sums and both routes' Horner steps) and at those of phase 8's sharded
     path on this machine's meshes (per rank the level-1 scans of the
     dense h, a, b1 and b2 MSMs over its shard, threshold terms, final
     scans, the reduction of the gathered window sums and the Horner
     steps), at prim_bench's (2^20 lanes and its tree reduction's
     halvings) and at phase 10's largest (the h MSM's level-1 scans at
     2^22 and B = 8, the b2 dense fallback's of full1024 and full4kb), the
     widths past the bulk one as the bulk lanes tiled, each tile held to
     the plain version's; times per launch beside the plain version's;
  3. a small end-to-end run: a synthetic circuit on a 2^10 domain, setup,
     two prove_batch calls at B = 2 on one key with witnesses from two
     seeds (each signal MSM's outcome under the signal plan: hit, or miss),
     all proofs verify and a tampered public fails; on the card, a stale
     plan is refused by both pruned MSMs, the b2 MSM's dense fallback gives
     the bucket route's b2, and a prove under a stale plan verifies;
  4. the full-width run: a synthetic R1CS of the full EmailVerifier's
     dimensions (1,351,641 constraints, 1,310,234 signals, 2^21 domain),
     setup on the card, prove_batch at B = 2 (the sort route), then the
     same witnesses on the bucket route (scripts/msm_routes.py::
     bucket_points, every MSM through msm_multi) blinded under the same
     rng: the proofs verify, a tampered public fails and the two routes'
     proofs are identical; both routes' stage timers and kernel launch
     counts, each count of the sort route non-zero; the b2 MSM once more
     by msm_bitserial, equal to the pruned sort result; the level-1
     additions of the signal MSMs, dense and pruned;
  5. the email path at full width, by the port's own code alone: build and
     compile the full640 EmailVerifier (header 640, body 768: 1,351,641
     constraints, 1,310,234 signals), sign B = 2 distinct emails with a
     seeded RSA-2048 key, verify DKIM and generate the circuit inputs on the
     host, compute the witness on the card (K1 launches, widths and host
     syncs counted), check A·w ∘ B·w = C·w on the card and the public
     outputs against host values (Poseidon of the key, SHA-256 of the
     signed header), then setup and prove_batch on the real witness (stage
     timers, signal plan): the proofs verify and a tampered public fails; a
     flipped signature bit gives a witness that does not satisfy the R1CS;
     and at header 448 / body 192 the card's witness equals the CPU's (the
     plain versions) limb for limb;
  6. phase 5's key from disk: export_chunked -> load_chunked onto the card,
     and write_zkey_file -> read_zkey_file (the conversions on the card,
     K1 launches counted), each loaded key with an empty cache proving phase
     5's proofs under the same rng (its signal plan built on first use);
     then groth16_setup_cached in a fresh directory, a miss and a hit, both
     equal to the setup; times and file sizes; the files are deleted;
  7. the rest of bench.py's circuits at full width, B = 2: full640reveal,
     sha640 and rsa2048 (models/subcircuits.py), each built, compiled, given
     the benchmark's signed emails (subcircuit_inputs, reveal_window), its
     witness on the card satisfying the R1CS with the host's publics, set up
     by groth16_setup_cached and proved, the proofs verifying and a tampered
     public refused; and the EmailVerifier's remove_soft_line_breaks at
     448/192 on bodies with quoted-printable breaks: the card's witness
     equals the CPU's and satisfies the R1CS, its step count printed;
  8. the multi-GPU prove (scripts/sharded_prove.py::run_meshes): phase 5's
     key (phase 6's chunk export), circuit and witnesses through files to
     ranks spawned by parallel/launch.py, each proving the batch with
     prove_batch(mesh=): with N >= 2 cards NCCL over N ranks at
     make_mesh(N) and at (1, N); with one card NCCL at world size 1 (mesh
     1 x 1), then two gloo ranks sharing the card at (1, 2), so that the
     two-way sharded NTT and the per-shard MSMs with their gathers run at
     full width. Every rank's proofs equal phase 5's, verify and refuse a
     tampered public, every rank launches K1, K2 and K3; one line per mesh
     with the stage and gather seconds, launches and peak memory per rank;
  9. tools and registry: (a) pubkey_hashes of 65,536 2048-bit moduli (a
     registry crawl's batch) on the card, equal to the same function with
     K1's plain version over the whole batch and to poseidon_large on the
     first 256, with its wall time and keys/s; (b) phase 5's proofs through
     the native C++ verifier (tampered public refused), and the codegen
     CLI's generated verifier of phase 5's key compiled by g++: rc 0 on a
     proof, 1 on a tampered proof byte, 2 with no arguments; (c)
     update_dkim_registry --local-keys over three seeded RSA signers and an
     ed25519 one: each RSA pubkeyHash equal to (a)'s and to
     poseidon_large, the ed25519 mail verified as unprovable; (d)
     msm_stress at 1,310,234 points, batch 4 (G1 sort, G1 bucket, G2 sort)
     and (e) prim_bench at 2^20, their JSON lines printed; the kernels'
     widths on this path are recorded, and those phase 2 did not check
     (the MSMs' at batch 4) are held to the plain versions and timed;
 10. bench.py's largest circuits, full1024 (header 1024, body 1536) and
     full4kb (header 1024, body 4096), both on a 2^22 domain, at bench.py's
     batch of 8: each built and compiled, its 8 bench emails (bench_emails)
     and one seeded email whose body fills most of the body length
     (long_body_email) through DKIM and prepare_inputs, the witness of the
     8 on the card (cold and warm; K1 launches, host syncs, peak memory)
     satisfying the R1CS with the host's publics, the long-body email's
     witness at B = 1 too (at full4kb also equal to the CPU's limb for
     limb), setup by groth16_setup and groth16_setup_cached (a miss and a
     hit in a directory of the run's own, both equal to the setup), and
     prove_batch with its stage timers and peak memory: all 8 proofs
     verify under the native verifier with the host's publics, the first
     under the pairing oracle too, and a tampered public is refused by
     both. Each config's key, circuit and witness are freed before the
     next; the widths this path launched each kernel at that no earlier
     check reached are held to the plain versions and timed.

It then prints one JSON line with each kernel's numbers (launches: the sort
route's prove in phase 4; launches_witness and launches_email: phase 5's
witness and its prove; launches_key_load, launches_zkey_write and
launches_zkey_read: phase 6's loaders; launches_<config>_prove: the proves
of phase 7 and of phase 10; launches_sharded_prove: phase 8's, over all
ranks and meshes; launches_tools: phase 9's (a), (d) and (e)), the
card's name and power limit, and last
{"ok": true, "device": {...}}. Any failure is an uncaught exception and a
non-zero exit; without a CUDA device it exits 1 before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import random
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Dimensions of the full EmailVerifier circuit (full640, BENCH_r05.json).
FULL640 = {"n_constraints": 1_351_641, "n_signals": 1_310_234}
FULL640_LENGTHS = (640, 768)  # max header and body bytes (bench.py CONFIGS)
SMALL_LENGTHS = (448, 192)  # the card-against-CPU witness checks
# a quoted-printable body with two soft line breaks (remove_soft_line_breaks)
SOFT_BODY = (b"A quoted-printable body whose long line is soft=\r\n"
             b"broken twice, here=\r\nand here.\r\n")
# K1 widths of the email witness besides the bulk (lanes, at B = 2): the
# Fermat inversion chains of is_zero (1), the Poseidon S-boxes (20) and MDS
# products (200), the FpMul evaluation products (17 x 33 x 2)
K1_WITNESS_WIDTHS = (1, 20, 200, 1122)
# Phase 9: the DKIM registry's batch of keys, hashed by pubkey_hashes
# (Poseidon at t = 10), and the K1 widths it launches at: the partial
# rounds' S-boxes and the conversion out (B), the conversion in (9 B), the
# full rounds' S-boxes (10 B) and the MDS products (100 B)
REGISTRY_KEYS = 65_536
K1_POSEIDON_WIDTHS = (REGISTRY_KEYS, 9 * REGISTRY_KEYS, 10 * REGISTRY_KEYS,
                      100 * REGISTRY_KEYS)
# phase 9's tools: msm_stress at full640's signal count, batch 4; prim_bench
# at 2^20 lanes, whose K2 widths are 2^20 and its tree reduction's halvings
STRESS_N, STRESS_BATCH = FULL640["n_signals"], 4
PRIM_N = 1 << 20
PRIM_K2_WIDTHS = tuple(PRIM_N >> i for i in range(21))
SMALL = {"n_constraints": 1000, "n_signals": 960}
BATCH = 2
# Phase 10: bench.py's two largest configs (bench.py:43-55), both on a 2^22
# domain, at bench.py's default batch (BENCH_BATCH, bench.py:303)
BIG_CONFIGS = {
    "full1024": {"n_constraints": 2_190_813, "n_signals": 2_122_382},
    "full4kb": {"n_constraints": 3_392_429, "n_signals": 3_300_638},
}
BIG_BATCH = 8
BIG_H_POINTS = 1 << 22
K1_PLAIN_LANES = 1 << 23  # K1 past this width is held to the plain version by tiles
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT32_PER_CLK_PER_SM = 64  # 32-bit integer add/mul/logic results, sm_90

# Least work per lane of each kernel: 32-bit integer operations (a
# multiply-add counts one) and bytes read plus written. The operations are
# those of the field's arithmetic on 8 x 32-bit words, whatever layout a
# kernel uses. A Montgomery product is 2 * 2 * 8 * 8 multiply-adds (the low
# and high halves of a_i * b_j and of m_i * p_j), 8 quotient products m_i
# and 16 operations for the final conditional subtraction: 280. A field
# addition or subtraction is an 8-word carry chain, an 8-word chain with p
# and 8 selects: 24. K2 (RCB Algorithm 7 on G1) does 12 products and 27
# additions or subtractions; K3 (the same on G2, Karatsuba Fq2 products)
# does 42 and 108; a negated addend costs one subtraction per Fq component
# of y, on the negated lanes only. Conversions between the interchange
# limbs and words are left out: they are one implementation's cost.
L = 22
OPS_MUL = 2 * 2 * 8 * 8 + 8 + 16
OPS_ADD = 24
KERNELS = {
    "mont_mul": {
        "source": "zkemail_tpu_torch/ops/csrc/mont_mul.cu",
        "replaces": "zkemail_tpu/ops/pallas_field.py:153",
        "ops": OPS_MUL, "ops_neg": 0, "bytes": 3 * L * 4,
    },
    "ec_add_g1": {
        "source": "zkemail_tpu_torch/ops/csrc/ec_add_g1.cu",
        "replaces": "zkemail_tpu/ops/pallas_field.py:463",
        "ops": 12 * OPS_MUL + 27 * OPS_ADD, "ops_neg": OPS_ADD,
        "bytes": 9 * L * 4 + 4,
    },
    "ec_add_g2": {
        "source": "zkemail_tpu_torch/ops/csrc/ec_add_g2.cu",
        "replaces": "zkemail_tpu/ops/pallas_field.py:722",
        "ops": 42 * OPS_MUL + 108 * OPS_ADD, "ops_neg": 2 * OPS_ADD,
        "bytes": 18 * L * 4 + 4,
    },
}
H_POINTS = 1 << 21  # points of the full-width h query: the 2^21 domain
SPIN_CYCLES = 20_000_000  # about 10 ms: longer than queueing the timed calls


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events. The
    calls are queued behind a spin kernel, so that the events time the
    device's work and not the host's launching of small kernels."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from zkemail_tpu_torch.core import curve_torch as CT
    from zkemail_tpu_torch.core import field as F
    from zkemail_tpu_torch.core import limbs as LB
    from zkemail_tpu_torch.ops import field_kernels as FK
    from zkemail_tpu_torch.ops import kernel_build
    from zkemail_tpu_torch.ops import msm_sort as MS
    from zkemail_tpu_torch.ops.msm import fixed_base_batch, map_coords, msm_multi
    from zkemail_tpu_torch.prover import groth16 as G
    from zkemail_tpu_torch.prover.containers import verify
    from zkemail_tpu_torch.prover.groth16 import prove_batch
    from zkemail_tpu_torch.prover.setup import groth16_setup
    from zkemail_tpu_torch.scripts.msm_routes import bucket_points
    from zkemail_tpu_torch.scripts.synthetic_r1cs import make_circuit
    from zkemail_tpu_torch.circuits.r1cs import satisfied
    from zkemail_tpu_torch.core.poseidon import poseidon_large
    from zkemail_tpu_torch.helpers.dkim import verify_dkim_signature
    from zkemail_tpu_torch.helpers.input_gen import (
        InputGenArgs, generate_email_verifier_inputs)
    from zkemail_tpu_torch.helpers.testkit import LocalDKIMSigner
    from zkemail_tpu_torch.models.email_verifier import (
        EmailVerifierConfig, build_email_verifier)
    from zkemail_tpu_torch.models.input_bridge import prepare_inputs
    from zkemail_tpu_torch.models.subcircuits import (
        CONFIGS, bench_emails, build_bench_circuit, reveal_window, subcircuit_inputs)
    from zkemail_tpu_torch.prover.artifacts import QUERIES as ARTIFACT_QUERIES
    from zkemail_tpu_torch.prover.artifacts import export_chunked, load_chunked
    from zkemail_tpu_torch.prover.setup import groth16_setup_cached
    from zkemail_tpu_torch.prover.zkey import read_zkey_file, write_zkey_file
    from zkemail_tpu_torch.parallel.sharding import mesh_shape
    from zkemail_tpu_torch.scripts.sharded_prove import (
        mesh_configs, run_meshes, write_job_files)

    dev = torch.device("cuda")
    torch.set_grad_enabled(False)
    t_start = time.time()

    # -- 1. card and build ---------------------------------------------------
    t0 = time.time()
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = n_sm * INT32_PER_CLK_PER_SM * max_sm_mhz * 1e6
    kernel_build.library()
    log(f"phase 1 card+build: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {n_sm} SMs at {max_sm_mhz:.0f} MHz max "
        f"({int32_per_s / 1e12:.2f} T int32 op/s); build {time.time() - t0:.1f} s")
    for line in kernel_build.ptxas_log().splitlines():
        if line.startswith("==") or "registers" in line or "stack frame" in line:
            log(f"  {line.strip()}")

    # -- 2. kernels against their plain versions ------------------------------
    t0 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    results = {}

    def rand_fe(field: str, n: int) -> torch.Tensor:
        """Canonical limbs below p (top limb < the modulus' top limb), with
        0, 1 and p - 1 in lanes 0..2."""
        p = F.to_limbs((F.FQ if field == "Fq" else F.FR).p)
        x = torch.randint(0, 1 << F.LIMB_BITS, (L, n), dtype=torch.int32,
                          device=dev, generator=gen)
        x[L - 1] = torch.randint(0, p[-1], (n,), dtype=torch.int32, device=dev,
                                 generator=gen)
        x[:, 0:3] = 0
        x[0, 1] = 1
        x[:, 2] = torch.tensor(p, dtype=torch.int32, device=dev)
        x[0, 2] -= 1
        return x

    def record(name, max_err, k_ms, p_ms, lanes, neg_lanes=0):
        spec = KERNELS[name]
        ops = spec["ops"] * lanes + spec["ops_neg"] * neg_lanes
        by_bytes = spec["bytes"] * lanes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / int32_per_s * 1e3
        prev = results.get(name)
        if prev is None or prev["lanes"] < lanes:
            results[name] = {
                "lanes": lanes, "max_abs_err": max_err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            }
        elif max_err > prev["max_abs_err"]:
            prev["max_abs_err"] = max_err

    def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
        return int((a.long() - b.long()).abs().max())

    for field in ("Fq", "Fr"):
        n = 1 << 20
        a = rand_fe(field, n)
        b = rand_fe(field, n).flip(1).contiguous()
        k = FK.mont_mul_flat(field, a, b)
        ref = FK.mont_mul_plain(field, a, b)
        err = max_err(k, ref)
        if err:
            raise AssertionError(f"K1 {field}: kernel differs from plain (max {err})")
        k_ms = time_ms(torch, lambda: FK.mont_mul_flat(field, a, b), 20)
        p_ms = time_ms(torch, lambda: FK.mont_mul_plain(field, a, b), 3)
        record("mont_mul", err, k_ms, p_ms, n)
        log(f"  K1 mont_mul {field} {n} lanes: equal; {k_ms:.4f} ms/launch, "
            f"plain {p_ms:.3f} ms")
    def check_k1_width(w: int) -> None:
        """K1 (Fr) at w lanes against the plain version: every slice of w
        lanes of max(w, 64) fresh lanes; past K1_PLAIN_LANES, 2^20 fresh
        lanes tiled to w, each tile of the kernel's output held to the plain
        version's on the 2^20 lanes. Then timed at w lanes."""
        if w > K1_PLAIN_LANES:
            n = 1 << 20
            a, b = rand_fe("Fr", n), rand_fe("Fr", n).flip(1).contiguous()
            ref = FK.mont_mul_plain("Fr", a, b)
            tiles = -(-w // n)
            aw, bw = (x.repeat(1, tiles)[:, :w].contiguous() for x in (a, b))
            out = FK.mont_mul_flat("Fr", aw, bw)
            for lo in range(0, w, n):
                hi = min(lo + n, w)
                if max_err(out[:, lo:hi], ref[:, : hi - lo]):
                    raise AssertionError(f"K1 Fr at {w} lanes, lanes {lo}..{hi}: kernel "
                                         "differs from plain")
            del a, b, ref, out
        else:
            a_all = rand_fe("Fr", max(w, 64))
            b_all = rand_fe("Fr", max(w, 64)).flip(1).contiguous()
            for lo in range(0, max(w, 64), w):
                aw, bw = a_all[:, lo : lo + w].contiguous(), b_all[:, lo : lo + w].contiguous()
                err = max_err(FK.mont_mul_flat("Fr", aw, bw), FK.mont_mul_plain("Fr", aw, bw))
                if err:
                    raise AssertionError(f"K1 Fr at {w} lanes: kernel differs from plain")
        results["mont_mul"][f"ms_{w}"] = time_ms(
            torch, lambda: FK.mont_mul_flat("Fr", aw, bw), 200 if w <= 64 else 20)
        del aw, bw
        torch.cuda.empty_cache()

    # the email witness's widths and the registry Poseidon's (phase 9)
    for w in K1_WITNESS_WIDTHS + K1_POSEIDON_WIDTHS:
        check_k1_width(w)
    log("  K1 mont_mul Fr at " + ", ".join(
        f"{w} lanes: equal; {results['mont_mul'][f'ms_{w}']:.4f} ms/launch"
        for w in K1_WITNESS_WIDTHS + K1_POSEIDON_WIDTHS))

    def curve_operands(kind: str, n: int):
        """Random points p, q = s * G, with q the identity on lanes i % 7 == 0,
        q = p on i % 5 == 0 (P + P), q = p negated on i % 11 == 0
        (P + (-P)), neg set on i % 3 == 0 and i % 11 == 0, and on lanes
        i % 13 == 6 the coordinates p.x = 0 and q = (p - 1, p - 1, p - 1),
        not a point: the kernels must agree with the plain versions on any
        field values."""
        ops = CT.FQ_OPS if kind == "g1" else CT.FQ2_OPS
        s1 = LB.from_mont(LB.FR_SPEC, rand_fe("Fr", n))
        s2 = LB.from_mont(LB.FR_SPEC, rand_fe("Fr", n))
        p, q = fixed_base_batch(kind, s1), fixed_base_batch(kind, s2)
        i = torch.arange(n, device=dev)
        ident = CT.ec_identity(ops, (n,), dev)
        q = CT.ec_select(ops, i % 5 == 0, p, q)
        q = CT.ec_select(ops, i % 11 == 0, p, q)
        q = CT.ec_select(ops, i % 7 == 0, ident, q)
        p, q = (map_coords(pt, lambda c: c.contiguous()) for pt in (p, q))
        odd = i % 13 == 6
        for c in coords({"x": p["x"]}):
            c[:, odd] = 0
        p_minus_1 = torch.tensor(F.to_limbs(F.Q - 1), dtype=torch.int32, device=dev)
        for c in coords(q):
            c[:, odd] = p_minus_1[:, None]
        neg = ((i % 3 == 0) | (i % 11 == 0)).to(torch.int32)
        return p, q, neg

    def coords(pt):
        return [c for v in pt.values() for c in (v if isinstance(v, tuple) else (v,))]

    def lanes(pt, lo: int, hi: int):
        return map_coords(pt, lambda c: c[:, lo:hi].contiguous())

    def check(name, kern, plain, p, q, neg) -> int:
        k, ref = kern(p, q, neg), plain(p, q, neg)
        err = max(max_err(x, y) for x, y in zip(coords(k), coords(ref)))
        if err:
            raise AssertionError(f"{name} at {neg.numel()} lanes: kernel differs "
                                 f"from plain (max {err})")
        return err

    # The widths K2 and K3 run at on the MSM routes besides the bulk: the
    # sort route's level-1 scans (rows = B * windows, times blocks of K
    # points) of the h MSM and of the dense b2 fallback, its threshold terms
    # (rows x 2^(c-1)), the bucket route's running sums (64), the sort
    # route's per-row final scans (rows) and both routes' Horner steps (2).
    # Then those of phase 8's sharded path on this machine's meshes
    # (mesh_configs): a rank proves b = B / dp proofs over its 1 / msm of
    # each query, so its rows are b * windows; the level-1 scans of its
    # dense MSMs (the h block and the a, b1, b2 slices), its threshold
    # terms and final scans, the rank-order reduction of the gathered
    # window sums (the four G1 MSMs stacked, 4 x rows; b2, rows) and the
    # Horner steps (4 b lanes on G1, b on G2).
    nw = MS.n_windows_for(MS.C_BITS_SORT)
    rows = BATCH * nw

    def level1(n_points: int, n_rows: int = rows) -> int:
        return n_rows * -(-n_points // MS.K_BLOCK)

    g1_widths = [level1(H_POINTS), rows << (MS.C_BITS_SORT - 1), 64, rows, 2]
    g2_widths = [level1(FULL640["n_signals"]), 64, rows, 2]
    for _, world, dps in mesh_configs(torch.cuda.device_count()):
        for dp in dps:
            dp, msm = mesh_shape(world, dp)
            b = BATCH // dp
            r = b * nw
            sig = level1(-(-FULL640["n_signals"] // msm), r)
            g1_widths += [level1(H_POINTS // msm, r), sig, r << (MS.C_BITS_SORT - 1), r,
                          4 * r, 4 * b]
            g2_widths += [sig, r, b]
    g1_widths += PRIM_K2_WIDTHS  # phase 9's prim_bench

    def level1_calls(ops, n_points: int, n_rows: int) -> list:
        """The level-1 scan widths of a dense sort MSM over n_rows rows of
        n_points live digits: calls of MS._rows_per_call rows, the last one
        the rest."""
        per_call = MS._rows_per_call(ops, n_points, MS.K_BLOCK)
        return [level1(n_points, min(per_call, n_rows - r0))
                for r0 in range(0, n_rows, per_call)]

    # phase 10: the h MSM at 2^22 and the b2 dense fallback of full1024 and
    # full4kb, at B = 8
    big_rows = BIG_BATCH * nw
    g1_widths += level1_calls(CT.FQ_OPS, BIG_H_POINTS, big_rows)
    for dims in BIG_CONFIGS.values():
        g2_widths += level1_calls(CT.FQ2_OPS, dims["n_signals"], big_rows)
    route_widths = {
        "mont_mul": list(K1_WITNESS_WIDTHS + K1_POSEIDON_WIDTHS),
        "ec_add_g1": list(dict.fromkeys(g1_widths)),
        "ec_add_g2": list(dict.fromkeys(g2_widths)),
    }

    curve_kernels = {  # name: (kind, bulk lanes, kernel, plain version)
        "ec_add_g1": ("g1", 1 << 18, FK.ec_add_g1_flat, FK.ec_add_g1_plain),
        "ec_add_g2": ("g2", 1 << 16, FK.ec_add_g2_flat, FK.ec_add_g2_plain),
    }

    def check_curve_width(name: str, w: int) -> None:
        """K2 or K3 at w lanes against the plain version; then timed. Past
        the bulk width n the operands are n fresh lanes tiled to w, and each
        tile of the kernel's output is held to the plain version's on the n
        lanes (the kernels are lane-wise; the plain version at w lanes
        would not fit). Else every slice of w lanes of max(w, 64) fresh
        lanes is checked: all edge lanes at the narrow widths."""
        kind, n, kern, plain = curve_kernels[name]
        if w > n:
            p, q, neg = curve_operands(kind, n)
            ref = coords(plain(p, q, neg))
            tiles = -(-w // n)
            ps, qs = (map_coords(pt, lambda c: c.repeat(1, tiles)[:, :w].contiguous())
                      for pt in (p, q))
            ns = neg.repeat(tiles)[:w].contiguous()
            out = coords(kern(ps, qs, ns))
            for lo in range(0, w, n):
                hi = min(lo + n, w)
                err = max(max_err(x[:, lo:hi], y[:, : hi - lo]) for x, y in zip(out, ref))
                if err:
                    raise AssertionError(f"{name} at {w} lanes, lanes {lo}..{hi}: kernel "
                                         f"differs from plain (max {err})")
            del p, q, neg, ref, out
            reps = 5
        else:
            ps, qs, ns = curve_operands(kind, max(w, 64))
            for lo in range(0, max(w, 64), w):
                check(name, kern, plain, lanes(ps, lo, lo + w), lanes(qs, lo, lo + w),
                      ns[lo : lo + w].contiguous())
            ps, qs, ns = lanes(ps, 0, w), lanes(qs, 0, w), ns[:w].contiguous()
            reps = 200 if w <= 64 else 20
        results[name][f"ms_{w}"] = time_ms(torch, lambda: kern(ps, qs, ns), reps)
        del ps, qs, ns
        torch.cuda.empty_cache()

    for name, (kind, n, kern, plain) in curve_kernels.items():
        p, q, neg = curve_operands(kind, n)
        err = check(name, kern, plain, p, q, neg)
        k_ms = time_ms(torch, lambda: kern(p, q, neg), 20)
        p_ms = time_ms(torch, lambda: plain(p, q, neg), 2)
        record(name, err, k_ms, p_ms, n, int(neg.sum()))
        log(f"  K {name} {n} lanes: equal; {k_ms:.4f} ms/launch, plain {p_ms:.3f} ms")
        del p, q, neg
        for w in route_widths[name]:
            check_curve_width(name, w)
        log(f"  K {name} at " + ", ".join(
            f"{w} lanes: equal; {results[name][f'ms_{w}']:.4f} ms/launch"
            for w in route_widths[name]))
    del k, ref, a, b
    torch.cuda.empty_cache()
    log(f"phase 2 kernels vs plain: {time.time() - t0:.1f} s")

    # -- what the later phases share: launch counts by path, the widths a
    # path launches each kernel at, and the check of those phase 2 did not
    # hold to the plain versions
    path_launches = {}

    def counted(label, fn):
        """fn() with the launch counts set to 0 just before it and read just
        after (the device synchronized), as path_launches[label]; returns
        (fn's result, seconds)."""
        FK.reset_launches()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        path_launches[label] = dict(FK.LAUNCHES)
        return out, time.time() - t

    flat_fns = {"mont_mul": FK.mont_mul_flat, "ec_add_g1": FK.ec_add_g1_flat,
                "ec_add_g2": FK.ec_add_g2_flat}

    def recording_widths(seen: dict):
        """Each wrapper records its launches' widths, seen[kernel][lanes] =
        launches, until restore_kernels()."""
        def wrap(name, fn):
            def recorded(*args):
                n = args[-1].numel() if name != "mont_mul" else args[1].shape[1]
                seen[name][n] = seen[name].get(n, 0) + 1
                return fn(*args)
            return recorded
        for name, fn in flat_fns.items():
            setattr(FK, name + "_flat", wrap(name, fn))

    def restore_kernels():
        for name, fn in flat_fns.items():
            setattr(FK, name + "_flat", fn)

    bulk = {"mont_mul": 1 << 20, "ec_add_g1": 1 << 18, "ec_add_g2": 1 << 16}

    def check_new_widths(seen: dict) -> dict:
        """Each width in seen that no earlier check reached, held to the plain
        version and timed, then added to route_widths. Returns the new
        widths by kernel."""
        new_widths = {}
        for name, widths in seen.items():
            new = sorted(w for w in widths if w not in route_widths[name] and w != bulk[name])
            for w in new:
                if name == "mont_mul":
                    check_k1_width(w)
                else:
                    check_curve_width(name, w)
            route_widths[name] += new
            new_widths[name] = new
        return new_widths

    def keys_equal(a, b) -> bool:
        tabs = [(u, v) for q in ARTIFACT_QUERIES for k in "xyz"
                for u, v in zip(coords({k: getattr(a, q)[k]}), coords({k: getattr(b, q)[k]}))]
        host = ("domain_log2", "n_public", "n_constraints", "alpha_g1", "beta_g1", "beta_g2",
                "delta_g1", "delta_g2")
        return (all(torch.equal(u, v) for u, v in tabs)
                and all(getattr(a, h) == getattr(b, h) for h in host) and a.vk == b.vk)

    def make(dims: dict):
        t = time.time()
        circ = make_circuit(dims["n_constraints"], dims["n_signals"], seed=1)
        t_gen = time.time() - t
        t = time.time()
        FK.reset_launches()
        pk = groth16_setup(circ.r1cs, seed=3, device=dev)
        torch.cuda.synchronize()
        return circ, pk, {"gen_s": t_gen, "setup_s": time.time() - t,
                          "setup_launches": dict(FK.LAUNCHES)}

    def prove_checked(pk, circ, w, label: str):
        """prove_batch under random.Random(4), its proofs checked. Returns
        the proofs as comparable tuples, the stage timers and the prove's
        wall time."""
        timers = {}
        t = time.time()
        proofs = prove_batch(pk, circ.r1cs, w, rng=random.Random(4), timers=timers,
                             device=dev)
        t_prove = time.time() - t
        return checked(pk, circ, proofs, label), timers, t_prove

    def checked(pk, circ, proofs, label: str):
        """Every proof verifies and a tampered public is refused. Returns
        the proofs as comparable tuples."""
        for proof, publics in proofs:
            if len(publics) != circ.r1cs.n_public:
                raise AssertionError(f"{label}: {len(publics)} publics")
            if not verify(pk.vk, proof, publics):
                raise AssertionError(f"{label}: a proof does not verify")
            bad = [(publics[0] + 1) % F.R] + publics[1:]
            if verify(pk.vk, proof, bad):
                raise AssertionError(f"{label}: a tampered public verifies")
        return [(pr.a, pr.b, pr.c, tuple(pub)) for pr, pub in proofs]

    def affine_equal(ops, x, y) -> bool:
        ax, ay = CT.ec_to_affine(ops, x), CT.ec_to_affine(ops, y)
        return all(torch.equal(u, v) for k in ("x", "y", "inf")
                   for u, v in zip(coords({k: ax[k]}), coords({k: ay[k]})))

    def stale_plan(pk, w_t):
        """Replace the key's signal plan by one built from an all-zero
        batch: every prefix 0, so any nonzero digit misses it."""
        pk.cache.pop("signal_plan", None)
        return G._signal_plan(pk, torch.zeros_like(w_t))

    # -- 3. small end to end --------------------------------------------------
    t0 = time.time()
    circ, pk, ts = make(SMALL)
    for seed in (2, 5):
        _, timers, t_prove = prove_checked(pk, circ, circ.witness(BATCH, seed=seed),
                                           f"small, witness seed {seed}")
        log(f"  witness seed {seed}: proofs verify, tampered public refused; plan "
            f"{json.dumps(timers['plan'])}; prove {t_prove:.2f} s")
    w = circ.witness(BATCH, seed=5)
    w_t = LB.to_device(w, dev).movedim(2, 1)
    perm, prefixes, queries = stale_plan(pk, w_t)
    if MS.msm_sorted_pruned(CT.FQ_OPS, queries["a"], w_t, perm, prefixes) is not None:
        raise AssertionError("msm_sorted_pruned took a batch past its plan")
    if MS.msm_bitserial(CT.FQ2_OPS, queries["b2"], w_t, perm, prefixes) is not None:
        raise AssertionError("msm_bitserial took a batch past its plan")
    b2, outcome = G._msm_signal_call(pk, "b2", w_t, w_t)
    if outcome != "miss" or not affine_equal(
            CT.FQ2_OPS, b2, msm_multi(CT.FQ2_OPS, pk.b2_query, w_t)):
        raise AssertionError(f"b2 dense fallback: {outcome}, or differs from bucket b2")
    stale_plan(pk, w_t)
    _, timers, _ = prove_checked(pk, circ, w, "small, stale plan")
    if timers["plan"]["a"] != "miss":
        raise AssertionError(f"stale plan not missed: {timers['plan']}")
    log(f"phase 3 small e2e (2^{pk.domain_log2} domain, B={BATCH}): stale plan "
        f"refused by both pruned MSMs; b2 dense fallback equals the bucket b2; "
        f"stale-plan prove {json.dumps(timers['plan'])} verifies; {json.dumps(ts)}; "
        f"{time.time() - t0:.1f} s")
    del pk, queries

    # -- 4. full width ---------------------------------------------------------
    t0 = time.time()
    circ, pk, ts = make(FULL640)
    w = circ.witness(BATCH, seed=2)
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    sort_proofs, sort_timers, t_sort = prove_checked(pk, circ, w, "full, sort")
    launches = dict(FK.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 4 full width (2^{pk.domain_log2} domain, {FULL640['n_signals']} "
        f"signals, B={BATCH}): {json.dumps(ts)}")
    log(f"  sort route (prove_batch): proofs verify, tampered public refused; prove "
        f"{t_sort:.2f} s; timers {json.dumps(sort_timers)}; launches "
        f"{json.dumps(launches)}; peak {peak_gb:.1f} GB")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sort route: {missing}")

    perm, prefixes, queries = pk.cache["signal_plan"]
    n_sig = FULL640["n_signals"]
    dense_adds = BATCH * len(prefixes) * n_sig
    pruned_adds = BATCH * sum(prefixes)
    log(f"  signal plan: prefixes {list(prefixes)}; level-1 lane-adds per signal "
        f"MSM dense {dense_adds}, pruned {pruned_adds} ({pruned_adds / dense_adds:.4f})")
    w_t = LB.to_device(w, dev).movedim(2, 1)
    t = time.time()
    b2_sort = MS.msm_sorted_pruned(CT.FQ2_OPS, queries["b2"], w_t, perm, prefixes)
    torch.cuda.synchronize()
    t_b2_sort = time.time() - t
    t = time.time()
    b2_bits = MS.msm_bitserial(CT.FQ2_OPS, queries["b2"], w_t, perm, prefixes)
    torch.cuda.synchronize()
    t_b2_bits = time.time() - t
    if not affine_equal(CT.FQ2_OPS, b2_sort, b2_bits):
        raise AssertionError("msm_bitserial b2 differs from msm_sorted_pruned b2")
    log(f"  b2 on the permuted query: msm_bitserial equals msm_sorted_pruned; "
        f"{t_b2_bits:.3f} s against {t_b2_sort:.3f} s")
    del b2_sort, b2_bits, queries, w_t

    FK.reset_launches()
    bucket_timers = {}
    t = time.time()
    w_dev = LB.to_device(w, dev)
    points = bucket_points(pk, circ.r1cs, w_dev, bucket_timers)
    bucket_proofs = G.blind(pk, points, w_dev, random.Random(4))
    t_bucket = time.time() - t
    bucket_launches = dict(FK.LAUNCHES)
    bucket_proofs = checked(pk, circ, bucket_proofs, "full, bucket")
    del points, w_dev
    if bucket_proofs != sort_proofs:
        raise AssertionError("the bucket route's proofs differ from the sort route's")
    log(f"  bucket route: proofs verify and equal the sort route's; prove "
        f"{t_bucket:.2f} s; timers {json.dumps(bucket_timers)}; launches "
        f"{json.dumps(bucket_launches)}; phase {time.time() - t0:.1f} s")

    del pk, circ, w, sort_proofs, bucket_proofs
    torch.cuda.empty_cache()

    # -- 5. the email path at full width -----------------------------------------
    t0 = time.time()
    signer = LocalDKIMSigner(seed=2026)
    emails = [
        signer.sign_email(subject="Full-width proof, email one",
                          body=b"The first email proved on the card.\r\n"),
        signer.sign_email(subject="Email two", to="carol@example.net",
                          body=b"A second body,\r\nwith two lines.\r\n"),
    ]

    def email_inputs(lengths, batch, device):
        cfg = EmailVerifierConfig(max_headers_length=lengths[0], max_body_length=lengths[1])
        args = InputGenArgs(max_headers_length=lengths[0], max_body_length=lengths[1])
        raws = [generate_email_verifier_inputs(e, signer.resolver(), args) for e in batch]
        return cfg, raws, prepare_inputs(raws, cfg, device=device)

    t = time.time()
    cfg = EmailVerifierConfig(*FULL640_LENGTHS)
    handles = build_email_verifier(cfg)
    t_build = time.time() - t
    t = time.time()
    cc = handles.cs.compile()
    t_compile = time.time() - t
    dims = {"n_constraints": cc.n_constraints, "n_signals": cc.n_signals}
    full640_steps = len(cc.steps)
    if dims != FULL640:
        raise AssertionError(f"full640 built with {dims}, expected {FULL640}")
    t = time.time()
    dkims = [verify_dkim_signature(e, signer.resolver()) for e in emails]
    _, raws, inputs = email_inputs(FULL640_LENGTHS, emails, dev)
    torch.cuda.synchronize()
    t_inputs = time.time() - t
    log(f"phase 5 email path (full640, B={BATCH}): build {t_build:.2f} s, compile "
        f"{t_compile:.2f} s ({cc.n_constraints} constraints, {cc.n_signals} signals, "
        f"{len(cc.steps)} witness steps); DKIM verify + inputs {t_inputs:.3f} s")

    def witness(inputs, stats=None):
        t = time.time()
        w = cc.eval_witness(inputs, BATCH, device=dev, stats=stats)
        torch.cuda.synchronize()
        return w, time.time() - t

    k1_widths = {}
    mont_mul_flat = FK.mont_mul_flat

    def counting_mont_mul(field, x, y):  # K1 widths of the witness run
        k1_widths[x.shape[1]] = k1_widths.get(x.shape[1], 0) + 1
        return mont_mul_flat(field, x, y)

    _, t_cold = witness(inputs)  # moves the steps' constants to the card
    FK.reset_launches()
    FK.mont_mul_flat = counting_mont_mul
    try:
        w, t_warm = witness(inputs)
    finally:
        FK.mont_mul_flat = mont_mul_flat
    witness_launches = dict(FK.LAUNCHES)
    if witness_launches["mont_mul"] == 0:
        raise AssertionError("K1 not launched by the witness")
    _, t_again = witness(inputs)
    stats = {}
    _, t_stats = witness(inputs, stats)
    top = sorted(k1_widths.items(), key=lambda kv: -kv[1])[:8]
    steps_s = dict(sorted(((k, round(v, 4)) for k, v in stats["steps_s"].items()),
                          key=lambda kv: -kv[1]))
    log(f"  witness on the card: cold {t_cold:.3f} s, warm {t_warm:.3f} / {t_again:.3f} s "
        f"({t_warm / BATCH * 1e3:.1f} / {t_again / BATCH * 1e3:.1f} ms per email); "
        f"launches {json.dumps(witness_launches)}; K1 widths (lanes: launches) "
        f"{json.dumps(dict(top))}; host syncs {stats['syncs']}")
    log(f"  witness by step kind (synchronized after each step, {t_stats:.3f} s): "
        f"{json.dumps(steps_s)}")
    t = time.time()
    ok = satisfied(cc, w)
    torch.cuda.synchronize()
    if not bool(ok.all()):
        raise AssertionError(f"the card's witness does not satisfy the R1CS: {ok.tolist()}")
    t_check = time.time() - t
    n_key = signer.public_key[0]
    for b, res in enumerate(dkims):
        digest = hashlib.sha256(res.headers).digest()
        want = [poseidon_large(n_key, 121, 9), int.from_bytes(digest[:16], "big"),
                int.from_bytes(digest[16:], "big")]
        got = [int(v) for v in LB.limbs_to_ints(w[:, 1 : cc.n_public + 1, b])]
        if got != want:
            raise AssertionError(f"email {b}: publics {got} differ from host {want}")
    log(f"  A·w ∘ B·w = C·w on the card for both emails ({t_check:.2f} s); pubkeyHash, "
        f"shaHi, shaLo equal the host's Poseidon and SHA-256")

    t = time.time()
    pk = groth16_setup(cc, seed=3, device=dev)
    torch.cuda.synchronize()
    t_setup = time.time() - t
    FK.reset_launches()
    timers = {}
    t = time.time()
    proofs = prove_batch(pk, cc, w, rng=random.Random(4), timers=timers, device=dev)
    t_prove = time.time() - t
    email_launches = dict(FK.LAUNCHES)
    missing = [k for k, v in email_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the email prove: {missing}")
    for proof, publics in proofs:
        if not verify(pk.vk, proof, publics):
            raise AssertionError("an email proof does not verify")
        if verify(pk.vk, proof, [(publics[0] + 1) % F.R] + publics[1:]):
            raise AssertionError("an email proof verifies with a tampered public")
    _, prefixes, _ = pk.cache["signal_plan"]
    dense_adds = BATCH * len(prefixes) * cc.n_signals
    pruned_adds = BATCH * sum(prefixes)
    log(f"  setup {t_setup:.2f} s (the matrices already on the card: satisfied uploaded "
        f"them); prove_batch {t_prove:.2f} s: proofs verify, tampered "
        f"public refused; timers {json.dumps(timers)}; launches "
        f"{json.dumps(email_launches)}")
    log(f"  signal plan: prefixes {list(prefixes)}; level-1 lane-adds per signal MSM "
        f"dense {dense_adds}, pruned {pruned_adds} ({pruned_adds / dense_adds:.4f})")
    email_proofs = [(pr.a, pr.b, pr.c, tuple(pub)) for pr, pub in proofs]
    del proofs
    torch.cuda.empty_cache()

    bad = dict(raws[0])
    sig = [int(v) for v in bad["signature"]]
    sig[0] ^= 1
    bad["signature"] = [str(v) for v in sig]
    w_bad, _ = witness(prepare_inputs([bad, raws[1]], cfg, device=dev))
    ok = satisfied(cc, w_bad).tolist()
    if ok != [False, True]:
        raise AssertionError(f"flipped signature bit: satisfied {ok}, expected [False, True]")
    del w_bad, inputs
    log("  a flipped signature bit: the witness does not satisfy the R1CS")

    t = time.time()
    cfg_s, _, inputs_card = email_inputs(SMALL_LENGTHS, emails, dev)
    cc_s = build_email_verifier(cfg_s).cs.compile()
    w_card = cc_s.eval_witness(inputs_card, BATCH, device=dev)
    _, _, inputs_cpu = email_inputs(SMALL_LENGTHS, emails, "cpu")
    t_cpu = time.time()
    w_cpu = cc_s.eval_witness(inputs_cpu, BATCH, device="cpu")
    t_cpu = time.time() - t_cpu
    if not torch.equal(w_card.cpu(), w_cpu):
        diff = int((w_card.cpu() != w_cpu).any(dim=0).any(dim=1).sum())
        raise AssertionError(f"448/192: the card's witness differs from the CPU's "
                             f"at {diff} signals")
    log(f"  448/192 ({cc_s.n_signals} signals): the card's witness equals the CPU's "
        f"limb for limb (CPU witness {t_cpu:.1f} s); {time.time() - t:.1f} s")
    del cc_s, w_card, w_cpu
    log(f"phase 5: {time.time() - t0:.1f} s")

    # -- 6. keys from disk at full640 --------------------------------------------
    t0 = time.time()

    def proves_as_phase5(key, label):
        """prove_batch on a loaded key (empty cache: the signal plan is
        built from this batch) gives phase 5's proofs under the same rng."""
        if key.cache:
            raise AssertionError(f"{label}: the loaded key has a cache {list(key.cache)}")
        timers = {}
        got, t_prove = counted(f"prove_{label}", lambda: prove_batch(
            key, cc, w, rng=random.Random(4), timers=timers, device=dev))
        if [(pr.a, pr.b, pr.c, tuple(pub)) for pr, pub in got] != email_proofs:
            raise AssertionError(f"{label}: proofs differ from phase 5's")
        missing = [k for k, v in path_launches[f"prove_{label}"].items() if v == 0]
        if missing or "signal_plan" not in key.cache:
            raise AssertionError(f"{label}: kernels {missing} not launched, or no plan built")
        log(f"  prove_batch on the {label} key: {t_prove:.2f} s, proofs equal phase 5's; "
            f"plan built on first use, {json.dumps(timers['plan'])}; timers "
            f"{json.dumps({k: v for k, v in timers.items() if k != 'plan'})}")

    def dir_bytes(path) -> int:
        return sum(f.stat().st_size for f in Path(path).iterdir())

    # phase 8's files: the chunk export, the circuit and the witnesses
    mesh_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    mesh_dir = Path(mesh_tmp.name)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_keys_") as tmp:
        tmp = Path(tmp)
        manifest, t_export = counted("export", lambda: export_chunked(pk, tmp / "chunks",
                                                                     name="full640"))
        stream = sum(ch["bytes"] for ch in manifest["chunks"])
        gz = dir_bytes(tmp / "chunks")
        pk_c, t_load = counted("key_load", lambda: load_chunked(tmp / "chunks", "full640",
                                                               device=dev))
        if not keys_equal(pk_c, pk):
            raise AssertionError("the chunk-loaded key differs from the setup's")
        shutil.move(tmp / "chunks", mesh_dir / "chunks")
        mesh_job = write_job_files(mesh_dir, cc, w, mesh_dir / "chunks", "full640")
        full640_vk = pk.vk
        log(f"phase 6 keys from disk (full640): export_chunked {t_export:.2f} s ({stream} B "
            f"stream, {gz} B in {len(manifest['chunks'])} gzip chunks), load_chunked "
            f"{t_load:.2f} s (launches {json.dumps(path_launches['key_load'])}): equal tables")
        proves_as_phase5(pk_c, "chunk-loaded")
        del pk_c
        torch.cuda.empty_cache()

        zkey_path = tmp / "full640.zkey"
        _, t_zwrite = counted("zkey_write", lambda: write_zkey_file(pk, zkey_path, cc))
        zkey_size = zkey_path.stat().st_size
        (pk_z, coeffs), t_zread = counted("zkey_read", lambda: read_zkey_file(zkey_path,
                                                                            device=dev))
        zkey_path.unlink()
        n_inst = cc.n_public + 1
        if (pk_z.n_constraints != cc.n_constraints
                or not np.array_equal(coeffs["A"][0][:-n_inst], cc.A[0])
                or not np.array_equal(coeffs["B"][1], cc.B[1])
                or not (coeffs["A"][2][:-n_inst] == cc.A[2]).all()
                or not (coeffs["B"][2] == cc.B[2]).all()):
            raise AssertionError("the zkey's coefficients or constraint count differ from the circuit's")
        for label in ("zkey_write", "zkey_read"):
            if path_launches[label]["mont_mul"] == 0:
                raise AssertionError(f"K1 not launched by {label}")
        log(f"  write_zkey_file {t_zwrite:.2f} s, read_zkey_file {t_zread:.2f} s ({zkey_size} B; "
            f"K1 launches write {path_launches['zkey_write']['mont_mul']}, read "
            f"{path_launches['zkey_read']['mont_mul']}); coefficients and n_constraints "
            f"{pk_z.n_constraints} equal the circuit's")
        proves_as_phase5(pk_z, "zkey-read")
        del pk_z, coeffs
        torch.cuda.empty_cache()

        cache_dir = tmp / "setup_cache"
        pk_miss, t_miss = counted("setup_cached_miss", lambda: groth16_setup_cached(
            cc, seed=3, cache_dir=str(cache_dir), device=dev))
        stored = [p.name for p in cache_dir.iterdir()]
        pk_hit, t_hit = counted("setup_cached_hit", lambda: groth16_setup_cached(
            cc, seed=3, cache_dir=str(cache_dir), device=dev))
        if not (keys_equal(pk_miss, pk) and keys_equal(pk_hit, pk) and not pk_hit.cache):
            raise AssertionError("groth16_setup_cached: the miss or the hit differs from setup")
        log(f"  groth16_setup_cached: miss {t_miss:.2f} s (setup + export to {stored}), hit "
            f"{t_hit:.2f} s; both equal phase 5's setup")
        del pk_miss, pk_hit
    del pk, w
    torch.cuda.empty_cache()
    log(f"phase 6: {time.time() - t0:.1f} s")

    # -- 7. the rest of bench.py's circuits at full width ---------------------------
    t0 = time.time()
    bench_signer = LocalDKIMSigner(seed=2027)
    bench_dkims = [verify_dkim_signature(e, bench_signer.resolver())
                   for e in bench_emails(bench_signer, BATCH)]
    n_bench = bench_signer.public_key[0]

    def host_publics(kind: str, b: int) -> list:
        """The publics of bench email b, computed on the host."""
        digest = hashlib.sha256(bench_dkims[b].headers).digest()
        sha = [int.from_bytes(digest[:16], "big"), int.from_bytes(digest[16:], "big")]
        if kind == "sha":
            return sha
        out = [poseidon_large(n_bench, 121, 9)] + sha
        if kind == "email_reveal":
            window = f"subject:bench email {b}".encode().ljust(2 * 31, b"\x00")
            out += [int.from_bytes(window[:31], "little"), int.from_bytes(window[31:], "little")]
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_setup_") as cache_dir:
        for name in ("full640reveal", "sha640", "rsa2048"):
            spec = CONFIGS[name]
            kind = spec["kind"]
            t_c = time.time()
            t = time.time()
            cs = build_bench_circuit(spec)
            t_build = time.time() - t
            t = time.time()
            cc = cs.compile()
            t_compile = time.time() - t
            del cs
            t = time.time()
            if kind == "email_reveal":
                args = InputGenArgs(max_headers_length=FULL640_LENGTHS[0],
                                    max_body_length=FULL640_LENGTHS[1])
                raws = [generate_email_verifier_inputs(e, bench_signer.resolver(), args)
                        for e in bench_emails(bench_signer, BATCH)]
                inputs = prepare_inputs(raws, EmailVerifierConfig(*FULL640_LENGTHS), device=dev)
                inputs.update(reveal_window(raws, device=dev))
            else:
                inputs = subcircuit_inputs(kind, spec, BATCH, bench_signer, device=dev)
            torch.cuda.synchronize()
            t_inputs = time.time() - t
            w, t_cold = counted(f"{name}_witness_cold",
                                lambda: cc.eval_witness(inputs, BATCH, device=dev))
            w, t_warm = counted(f"{name}_witness", lambda: cc.eval_witness(inputs, BATCH,
                                                                        device=dev))
            t = time.time()
            ok = satisfied(cc, w)
            torch.cuda.synchronize()
            t_check = time.time() - t
            if not bool(ok.all()):
                raise AssertionError(f"{name}: the card's witness does not satisfy the R1CS")
            for b in range(BATCH):
                got = [int(v) for v in LB.limbs_to_ints(w[:, 1 : cc.n_public + 1, b])]
                if got != host_publics(kind, b):
                    raise AssertionError(f"{name}, email {b}: publics {got} differ from the host's")
            t = time.time()
            pk = groth16_setup_cached(cc, seed=1, cache_dir=cache_dir, device=dev)
            torch.cuda.synchronize()
            t_setup = time.time() - t
            timers = {}
            proofs, t_prove = counted(f"{name}_prove", lambda: prove_batch(
                pk, cc, w, rng=random.Random(4), timers=timers, device=dev))
            missing = [k for k, v in path_launches[f"{name}_prove"].items() if v == 0]
            if missing:
                raise AssertionError(f"{name}: kernels not launched by the prove: {missing}")
            for proof, publics in proofs:
                if not verify(pk.vk, proof, publics):
                    raise AssertionError(f"{name}: a proof does not verify")
                if verify(pk.vk, proof, [(publics[0] + 1) % F.R] + publics[1:]):
                    raise AssertionError(f"{name}: a proof verifies with a tampered public")
            log(f"phase 7 {name} (B={BATCH}): {cc.n_constraints} constraints, {cc.n_signals} "
                f"signals, {cc.n_public} publics, {len(cc.steps)} witness steps, 2^"
                f"{pk.domain_log2} domain; build {t_build:.2f} s, compile {t_compile:.2f} s, "
                f"inputs {t_inputs:.3f} s; witness cold {t_cold:.3f} s, warm {t_warm:.3f} s "
                f"({t_warm / BATCH * 1e3:.1f} ms per email; K1 "
                f"{path_launches[f'{name}_witness']['mont_mul']}); satisfied on the card "
                f"({t_check:.2f} s), publics equal the host's; setup (groth16_setup_cached, "
                f"miss) {t_setup:.2f} s; prove_batch {t_prove:.2f} s, proofs verify, tampered "
                f"public refused; timers {json.dumps(timers)}; launches "
                f"{json.dumps(path_launches[f'{name}_prove'])}; {time.time() - t_c:.1f} s")
            del pk, cc, w, inputs, proofs
            torch.cuda.empty_cache()

    # remove_soft_line_breaks at 448/192 on quoted-printable bodies
    t = time.time()
    soft = [signer.sign_email(subject="Soft breaks", body=SOFT_BODY),
            signer.sign_email(subject="Soft breaks two", body=SOFT_BODY.replace(b"here", b"there"))]
    soft_cfg = EmailVerifierConfig(*SMALL_LENGTHS, remove_soft_line_breaks=True)
    soft_args = InputGenArgs(max_headers_length=SMALL_LENGTHS[0], max_body_length=SMALL_LENGTHS[1],
                              remove_soft_line_breaks=True)
    soft_raws = [generate_email_verifier_inputs(e, signer.resolver(), soft_args) for e in soft]
    for raw in soft_raws:
        body = bytes(int(v) for v in raw["emailBody"])
        if body.count(b"=\r\n") < 2 or b"=\r\n" in bytes(int(v) for v in raw["decodedEmailBodyIn"]):
            raise AssertionError("soft line breaks: the body holds no breaks, or the decoded one does")
    cc = build_email_verifier(soft_cfg).cs.compile()
    n_plain = len(build_email_verifier(EmailVerifierConfig(*SMALL_LENGTHS)).cs.compile().steps)
    soft_inputs = prepare_inputs(soft_raws, soft_cfg, device=dev)
    for _ in range(2):  # cold (the steps' constants move to the card), then warm
        w_card, t_soft = counted("soft_witness", lambda: cc.eval_witness(
            soft_inputs, BATCH, device=dev))
    t_cpu = time.time()
    w_cpu = cc.eval_witness(prepare_inputs(soft_raws, soft_cfg, device="cpu"), BATCH, device="cpu")
    t_cpu = time.time() - t_cpu
    if not torch.equal(w_card.cpu(), w_cpu):
        raise AssertionError("soft line breaks: the card's witness differs from the CPU's")
    if not bool(satisfied(cc, w_card).all()):
        raise AssertionError("soft line breaks: the card's witness does not satisfy the R1CS")
    n_full = len(build_email_verifier(EmailVerifierConfig(
        *FULL640_LENGTHS, remove_soft_line_breaks=True)).cs.steps)
    log(f"  remove_soft_line_breaks at {SMALL_LENGTHS[0]}/{SMALL_LENGTHS[1]} (B={BATCH}, two "
        f"quoted-printable breaks per body): {len(cc.steps)} witness steps ({n_plain} without "
        f"the flag; at 640/768 {n_full} against {full640_steps}); witness on the card warm "
        f"{t_soft:.3f} s (K1 {path_launches['soft_witness']['mont_mul']}), equal to the CPU's "
        f"limb for limb (CPU {t_cpu:.1f} s); satisfied on the card; {time.time() - t:.1f} s")
    del cc, w_card, w_cpu
    log(f"phase 7: {time.time() - t0:.1f} s")

    # -- 8. the multi-GPU prove ------------------------------------------------------
    t0 = time.time()
    n_cards = torch.cuda.device_count()
    sharded_launches = run_meshes(mesh_job, n_cards, email_proofs, full640_vk, card, log=log)
    mesh_tmp.cleanup()
    log(f"phase 8 multi-GPU prove ({n_cards} card{'s' if n_cards > 1 else ''}): launches "
        f"over all ranks and meshes {json.dumps(sharded_launches)}; {time.time() - t0:.1f} s")

    # -- 9. tools and registry -------------------------------------------------------
    t0 = time.time()
    seen_widths = {name: {} for name in FK.LAUNCHES}  # kernel: {lanes: launches}
    tool_labels = []

    def tool(label, fn):
        """fn() with its kernel launches counted (phase 9's path) and its
        widths recorded; returns (fn's result, seconds)."""
        recording_widths(seen_widths)
        try:
            out, secs = counted(label, fn)
        finally:
            restore_kernels()
        tool_labels.append(label)
        return out, secs

    # (a) the registry's batch: REGISTRY_KEYS odd 2048-bit moduli, three of
    # them (c)'s signers' keys, hashed on the card by pubkey_hashes
    from zkemail_tpu_torch.core.poseidon_torch import pubkey_hashes
    from zkemail_tpu_torch.helpers.dns import StaticResolver, parse_dkim_txt
    from zkemail_tpu_torch.helpers.testkit import LocalEd25519DKIMSigner

    rsa_signers = [LocalDKIMSigner(domain=d, selector=sel, seed=30 + i) for i, (d, sel) in
                   enumerate([("corp.example", "selector1"), ("corp.example", "google"),
                              ("mail.example", "s1")])]
    ed_signer = LocalEd25519DKIMSigner(domain="mail.example", selector="ed1", seed=34)
    rng = random.Random(2028)
    moduli = [s.public_key[0] for s in rsa_signers] + [
        rng.getrandbits(2048) | (1 << 2047) | 1 for _ in range(REGISTRY_KEYS - 3)]
    torch.cuda.reset_peak_memory_stats()
    _, t_cold = tool("registry_hash_cold", lambda: pubkey_hashes(moduli, device=dev))
    hashes, t_hash = tool("registry_hash", lambda: pubkey_hashes(moduli, device=dev))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if path_launches["registry_hash"]["mont_mul"] != 274:
        raise AssertionError(f"pubkey_hashes: {path_launches['registry_hash']} K1 launches, "
                             "expected 272 + 2")
    FK.mont_mul_flat = lambda field, x, y: FK.mont_mul_plain(field, x, y)
    try:
        t = time.time()
        plain_hashes = pubkey_hashes(moduli, device=dev)
        torch.cuda.synchronize()
        t_plain = time.time() - t
    finally:
        restore_kernels()
    if not torch.equal(hashes, plain_hashes):
        raise AssertionError("pubkey_hashes with K1 differs from its plain version")
    hash_ints = [int(v) for v in LB.limbs_to_ints(hashes)]
    t = time.time()
    if hash_ints[:256] != [poseidon_large(m, 121, 9) for m in moduli[:256]]:
        raise AssertionError("pubkey_hashes differs from poseidon_large")
    t_ref = time.time() - t
    log(f"phase 9 tools and registry: (a) pubkey_hashes of {REGISTRY_KEYS} keys on the card: "
        f"cold {t_cold:.3f} s, warm {t_hash:.3f} s ({REGISTRY_KEYS / t_hash:.0f} keys/s), "
        f"launches {json.dumps(path_launches['registry_hash'])}, peak {peak_gb:.2f} GB; "
        f"equal to K1's plain version on the card ({t_plain:.2f} s) over the batch and "
        f"to poseidon_large on the first 256 ({t_ref:.2f} s)")
    del plain_hashes

    # (b) the native verifier and the generated C++ verifier on phase 5's proofs
    import contextlib
    import io

    from zkemail_tpu_torch.native import codegen
    from zkemail_tpu_torch.native import verifier as native
    from zkemail_tpu_torch.prover.containers import Proof, publics_to_snarkjs

    t = time.time()
    native.build()
    t_build = time.time() - t
    for a_pt, b_pt, c_pt, pub in email_proofs:
        proof = Proof(a_pt, b_pt, c_pt)
        if not native.verify(full640_vk, proof, list(pub)):
            raise AssertionError("native verifier: a phase 5 proof does not verify")
        if native.verify(full640_vk, proof, [(pub[0] + 1) % F.R] + list(pub[1:])):
            raise AssertionError("native verifier: a tampered public verifies")
    a_pt, b_pt, c_pt, pub = email_proofs[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codegen_") as tmp:
        tmp = Path(tmp)
        (tmp / "vkey.json").write_text(json.dumps(full640_vk.to_snarkjs()))
        (tmp / "proof.json").write_text(json.dumps(Proof(a_pt, b_pt, c_pt).to_snarkjs()))
        (tmp / "public.json").write_text(json.dumps(publics_to_snarkjs(list(pub))))
        with contextlib.redirect_stdout(io.StringIO()):
            codegen.main(["generate-verifier", "-v", str(tmp / "vkey.json"),
                          "-o", str(tmp / "verifier.cpp")])
            codegen.main(["generate-verifier-arguments", "-p", str(tmp / "proof.json"),
                          "-i", str(tmp / "public.json"), "--out-dir", str(tmp / "args")])
        exe = tmp / "verifier"
        subprocess.run(["g++", "-O2", "-std=c++17", str(tmp / "verifier.cpp"), "-o", str(exe)],
                       check=True, capture_output=True)
        flat = [str(tmp / "args" / "proof.flat.bin"), str(tmp / "args" / "publics.flat.bin")]
        bad = bytearray((tmp / "args" / "proof.flat.bin").read_bytes())
        bad[5] ^= 1
        (tmp / "bad.bin").write_bytes(bytes(bad))
        rcs = [subprocess.run([str(exe), *argv], capture_output=True).returncode
               for argv in (flat, [str(tmp / "bad.bin"), flat[1]], [])]
    if rcs != [0, 1, 2]:
        raise AssertionError(f"generated verifier: exit codes {rcs}, expected [0, 1, 2]")
    log(f"  (b) native verifier (g++ build {t_build:.1f} s): phase 5's proofs verify, a "
        f"tampered public fails; codegen's C++ verifier of phase 5's key: rc 0 on its proof, "
        f"1 on a tampered proof byte, 2 with no arguments; {time.time() - t:.1f} s")

    # (c) the registry path offline: update_dkim_registry --local-keys
    from zkemail_tpu_torch.scripts import update_dkim_registry

    t = time.time()
    local = {}
    for sgn in rsa_signers + [ed_signer]:
        local.setdefault(sgn.domain, {})[sgn.selector] = sgn.dns_txt_record()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as tmp:
        tmp = Path(tmp)
        (tmp / "keys.json").write_text(json.dumps(local))
        with contextlib.redirect_stdout(io.StringIO()):
            update_dkim_registry.main(["--local-keys", str(tmp / "keys.json"), "--domains",
                                       "corp.example", "mail.example",
                                       "--output", str(tmp / "registry.json")])
        registry = json.loads((tmp / "registry.json").read_text())
    crawled = {(dom, e["selector"]): int(e["pubkeyHash"])
               for dom, entries in registry["keys"].items() for e in entries}
    want = {(sgn.domain, sgn.selector): hash_ints[i] for i, sgn in enumerate(rsa_signers)}
    if crawled != want or any(h != poseidon_large(sgn.public_key[0], 121, 9)
                              for h, sgn in zip(want.values(), rsa_signers)):
        raise AssertionError(f"registry: crawled hashes {crawled} differ from (a)'s "
                             "pubkey_hashes or poseidon_large")
    ed_resolver = StaticResolver({(ed_signer.domain, ed_signer.selector): [
        parse_dkim_txt(local[ed_signer.domain][ed_signer.selector])]})
    ed_res = verify_dkim_signature(ed_signer.sign_email(subject="ed25519 registry key"),
                                   ed_resolver)
    if ed_res.algo != "ed25519-sha256" or ed_res.circuit_provable:
        raise AssertionError("the ed25519 signer's email: not a verified, unprovable result")
    log(f"  (c) update_dkim_registry --local-keys: {len(crawled)} RSA keys crawled (the "
        f"ed25519 key skipped), each pubkeyHash equal to (a)'s and to poseidon_large, "
        f"{len(registry['calls'])} calldata entries; the ed25519 signer's email verifies "
        f"with circuit_provable=False; {time.time() - t:.1f} s")

    # (d) msm_stress at full640's signal count, batch 4; (e) prim_bench at 2^20
    from zkemail_tpu_torch.scripts import msm_stress, prim_bench

    tool_lines = {}
    for label, kind, algo in (("stress_g1_sort", "g1", "sort"),
                              ("stress_g1_bucket", "g1", "bucket"),
                              ("stress_g2_sort", "g2", "sort")):
        with contextlib.redirect_stdout(io.StringIO()):
            tool_lines[label], _ = tool(label, lambda: msm_stress.main([
                "--n", str(STRESS_N), "--batch", str(STRESS_BATCH), "--kind", kind,
                "--algo", algo, "--reps", "2"]))
        log(f"  (d) msm_stress {kind} {algo}: {json.dumps(tool_lines[label])}")
        torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        tool_lines["prim"], _ = tool("prim_bench", lambda: prim_bench.main(["--n", str(PRIM_N)]))
    log(f"  (e) prim_bench: {json.dumps(tool_lines['prim'])}")

    # the widths the tools launched each kernel at that phase 2 did not
    # check (the MSM routes' at batch 4): each against its plain version
    tools_launches = {k: sum(path_launches[lb][k] for lb in tool_labels) for k in FK.LAUNCHES}
    t = time.time()
    new_widths = check_new_widths(seen_widths)
    missing = [k for k, v in tools_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by phase 9's tools: {missing}")
    log(f"  launches on phase 9's path {json.dumps(tools_launches)}; widths (lanes: launches) "
        f"{json.dumps({k: dict(sorted(v.items())) for k, v in seen_widths.items()})}; "
        f"the {sum(map(len, new_widths.values()))} widths phase 2 had not checked equal the "
        f"plain versions ({time.time() - t:.1f} s)")
    log(f"phase 9: {time.time() - t0:.1f} s")

    # -- 10. bench.py's largest circuits at bench.py's batch -----------------------
    from zkemail_tpu_torch.models.subcircuits import long_body_email
    from zkemail_tpu_torch.native import verifier as native
    from zkemail_tpu_torch.prover.setup import matrix_pack

    t0 = time.time()
    big_signer = LocalDKIMSigner(seed=2029)
    big_emails = bench_emails(big_signer, BIG_BATCH)
    big_headers = [verify_dkim_signature(e, big_signer.resolver()).headers for e in big_emails]
    big_seen = {name: {} for name in FK.LAUNCHES}  # kernel: {lanes: launches}
    native.build()

    def email_publics(headers: bytes) -> list:
        """pubkeyHash, shaHi and shaLo of an email of big_signer, on the host."""
        digest = hashlib.sha256(headers).digest()
        return [poseidon_large(big_signer.public_key[0], 121, 9),
                int.from_bytes(digest[:16], "big"), int.from_bytes(digest[16:], "big")]

    def check_publics(label: str, w, headers: list) -> None:
        for b, hdr in enumerate(headers):
            got = [int(v) for v in LB.limbs_to_ints(w[:, 1:4, b])]
            if got != email_publics(hdr):
                raise AssertionError(f"{label}, email {b}: publics {got} differ from the host's")

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 1e9

    for name, dims in BIG_CONFIGS.items():
        t_c = time.time()
        spec = CONFIGS[name]
        lengths = (spec["max_headers_length"], spec["max_body_length"])
        cfg = EmailVerifierConfig(*lengths)
        args = InputGenArgs(max_headers_length=lengths[0], max_body_length=lengths[1])
        t = time.time()
        cs = build_bench_circuit(spec)
        t_build = time.time() - t
        t = time.time()
        cc = cs.compile()
        t_compile = time.time() - t
        del cs
        got = {"n_constraints": cc.n_constraints, "n_signals": cc.n_signals}
        if got != dims:
            raise AssertionError(f"{name} built with {got}, expected {dims}")
        t = time.time()
        raws = [generate_email_verifier_inputs(e, big_signer.resolver(), args) for e in big_emails]
        inputs = prepare_inputs(raws, cfg, device=dev)
        long_eml = long_body_email(big_signer, lengths[1], seed=1)
        long_raw = generate_email_verifier_inputs(long_eml, big_signer.resolver(), args)
        long_inputs = prepare_inputs([long_raw], cfg, device=dev)
        long_headers = [verify_dkim_signature(long_eml, big_signer.resolver()).headers]
        torch.cuda.synchronize()
        t_inputs = time.time() - t

        recording_widths(big_seen)
        try:
            torch.cuda.reset_peak_memory_stats()
            stats = {}
            _, t_cold = counted(f"{name}_witness_cold", lambda: cc.eval_witness(
                inputs, BIG_BATCH, device=dev, stats=stats))
            w, t_warm = counted(f"{name}_witness", lambda: cc.eval_witness(
                inputs, BIG_BATCH, device=dev))
            peak_witness = peak_gb()
            # the matrices' first upload (host limbs of every coefficient),
            # which satisfied and setup then find cached on the circuit
            _, t_upload = counted(f"{name}_upload",
                                  lambda: [matrix_pack(cc, m, w.device) for m in "ABC"])
            ok, t_check = counted(f"{name}_satisfied", lambda: satisfied(cc, w))
            if not bool(ok.all()):
                raise AssertionError(f"{name}: the card's witness does not satisfy the R1CS: "
                                     f"{ok.tolist()}")
            check_publics(name, w, big_headers)
            w_long, t_long = counted(f"{name}_long_witness", lambda: cc.eval_witness(
                long_inputs, 1, device=dev))
            if not bool(satisfied(cc, w_long).all()):
                raise AssertionError(f"{name}: the long-body witness does not satisfy the R1CS")
            check_publics(f"{name} long body", w_long, long_headers)

            torch.cuda.reset_peak_memory_stats()
            pk, t_setup = counted(f"{name}_setup", lambda: groth16_setup(cc, seed=5, device=dev))
            with tempfile.TemporaryDirectory(prefix="chip_smoke_big_setup_") as cache_dir:
                pk_miss, t_miss = counted(f"{name}_setup_miss", lambda: groth16_setup_cached(
                    cc, seed=5, cache_dir=cache_dir, device=dev))
                if not keys_equal(pk_miss, pk):
                    raise AssertionError(f"{name}: the setup cache's miss differs from setup")
                del pk_miss
                pk_hit, t_hit = counted(f"{name}_setup_hit", lambda: groth16_setup_cached(
                    cc, seed=5, cache_dir=cache_dir, device=dev))
                if not keys_equal(pk_hit, pk) or pk_hit.cache:
                    raise AssertionError(f"{name}: the setup cache's hit differs from setup")
                del pk_hit
            peak_setup = peak_gb()
            torch.cuda.empty_cache()

            torch.cuda.reset_peak_memory_stats()
            timers = {}
            proofs, t_prove = counted(f"{name}_prove", lambda: prove_batch(
                pk, cc, w, rng=random.Random(4), timers=timers, device=dev))
            peak_prove = peak_gb()
        finally:
            restore_kernels()
        missing = [k for k, v in path_launches[f"{name}_prove"].items() if v == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched by the prove: {missing}")

        t = time.time()
        for b, (proof, publics) in enumerate(proofs):
            if publics != email_publics(big_headers[b]):
                raise AssertionError(f"{name}, proof {b}: publics differ from the host's")
            if not native.verify(pk.vk, proof, publics):
                raise AssertionError(f"{name}: proof {b} does not verify (native)")
            if native.verify(pk.vk, proof, [(publics[0] + 1) % F.R] + publics[1:]):
                raise AssertionError(f"{name}: proof {b} verifies with a tampered public (native)")
        t_native = time.time() - t
        t = time.time()
        proof, publics = proofs[0]
        if not verify(pk.vk, proof, publics):
            raise AssertionError(f"{name}: proof 0 does not verify (pairing oracle)")
        if verify(pk.vk, proof, [(publics[0] + 1) % F.R] + publics[1:]):
            raise AssertionError(f"{name}: proof 0 verifies with a tampered public (oracle)")
        t_oracle = time.time() - t

        cpu_note = ""
        if name == "full4kb":  # the long-body witness on the card against the CPU's
            t = time.time()
            w_cpu = cc.eval_witness(prepare_inputs([long_raw], cfg, device="cpu"), 1,
                                    device="cpu")
            if not torch.equal(w_long.cpu(), w_cpu):
                diff = int((w_long.cpu() != w_cpu).any(dim=0).any(dim=1).sum())
                raise AssertionError(f"{name}: the long-body witness on the card differs from "
                                     f"the CPU's at {diff} signals")
            cpu_note = (f"; the long-body witness equals the CPU's limb for limb (CPU "
                        f"{time.time() - t:.1f} s)")
            del w_cpu

        k1 = {k: path_launches[f"{name}_{k}"]["mont_mul"]
              for k in ("witness", "long_witness", "setup")}
        log(f"phase 10 {name} (B={BIG_BATCH}, 2^{pk.domain_log2} domain): {cc.n_constraints} "
            f"constraints, {cc.n_signals} signals, {len(cc.steps)} witness steps; build "
            f"{t_build:.2f} s, compile {t_compile:.2f} s; DKIM + inputs {t_inputs:.3f} s "
            f"(long body {int(long_raw['emailBodyLength'])} of {lengths[1]} B)")
        log(f"  witness on the card: cold {t_cold:.3f} s, warm {t_warm:.3f} s "
            f"({t_warm / BIG_BATCH * 1e3:.1f} ms per email); K1 {k1['witness']}, host syncs "
            f"{stats['syncs']}; peak {peak_witness:.2f} GB; matrices' first upload "
            f"{t_upload:.2f} s; satisfied on the card ({t_check:.2f} s), publics equal the "
            f"host's; long body at B=1: witness {t_long:.3f} s (K1 {k1['long_witness']}), "
            f"satisfied, publics equal the host's{cpu_note}")
        log(f"  setup {t_setup:.2f} s (K1 {k1['setup']}), groth16_setup_cached miss "
            f"{t_miss:.2f} s, hit {t_hit:.2f} s, both equal the setup; peak {peak_setup:.2f} GB")
        log(f"  prove_batch {t_prove:.2f} s: timers {json.dumps(timers)}; launches "
            f"{json.dumps(path_launches[f'{name}_prove'])}; peak {peak_prove:.2f} GB; "
            f"{BIG_BATCH} proofs verify natively ({t_native:.2f} s) with the host's publics, "
            f"proof 0 under the pairing oracle ({t_oracle:.2f} s), a tampered public "
            f"refused by both; {time.time() - t_c:.1f} s")
        del pk, cc, w, w_long, inputs, long_inputs, proofs, ok
        torch.cuda.empty_cache()

    t = time.time()
    big_new = check_new_widths(big_seen)
    log(f"  widths on phase 10's path (lanes: launches) "
        f"{json.dumps({k: dict(sorted(v.items())) for k, v in big_seen.items()})}; the "
        f"{sum(map(len, big_new.values()))} widths no earlier check reached equal the plain "
        f"versions ({time.time() - t:.1f} s)")
    log(f"phase 10: {time.time() - t0:.1f} s")

    # -- 11. results -----------------------------------------------------------
    log(f"phases 1-10: {time.time() - t_start:.1f} s")
    line = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "launches_bucket": bucket_launches[name],
            "launches_witness": witness_launches[name],
            "launches_email": email_launches[name],
            **{f"launches_{label}": path_launches[label][name]
               for label in ("key_load", "zkey_write", "zkey_read")},
            **{f"launches_{label}_prove": path_launches[f"{label}_prove"][name]
               for label in ("full640reveal", "sha640", "rsa2048", *BIG_CONFIGS)},
            "launches_sharded_prove": sharded_launches[name],
            "launches_tools": tools_launches[name],
            **{f"ms_{w}": r.get(f"ms_{w}") for w in route_widths.get(name, ())},
        }
        for name, r in results.items()
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
