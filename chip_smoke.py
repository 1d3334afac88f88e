#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkemail_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the kernels from zkemail_tpu_torch/ops/csrc at first use, then:

  1. card and build: the card's name and power limit, versions, build time
     and what ptxas reported for each kernel;
  2. each kernel against its plain PyTorch version on the card, exactly:
     K1 mont_mul (Fq and Fr, 2^20 lanes, with 0, 1 and p - 1), K2 ec_add_g1
     (2^18 lanes) and K3 ec_add_g2 (2^16 lanes) with identity operands,
     P + P, P + (-P), negated lanes and coordinates 0 and p - 1, and K2 and
     K3 again at the MSM's small widths, 64 lanes and every pair of those as
     2 lanes; times per launch beside the plain version's;
  3. a small end-to-end run: a synthetic circuit on a 2^10 domain, setup,
     prove_batch at B = 2, both proofs verify and a tampered public fails;
  4. the full-width run: a synthetic R1CS of the full EmailVerifier's
     dimensions (1,351,641 constraints, 1,310,234 signals, 2^21 domain),
     setup on the card, prove_batch at B = 2 with its stage timers, both
     proofs verify and a tampered public fails; the kernel launch counts of
     this phase, each of which must be non-zero.

It then prints one JSON line with each kernel's numbers, the card's name and
power limit, and last {"ok": true, "device": {...}}. Any failure is an
uncaught exception and a non-zero exit; without a CUDA device it exits 1
before printing any result.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

# Dimensions of the full EmailVerifier circuit (full640, BENCH_r05.json).
FULL640 = {"n_constraints": 1_351_641, "n_signals": 1_310_234}
SMALL = {"n_constraints": 1000, "n_signals": 960}
BATCH = 2
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
# The curve kernels' lane counts on the main path besides the bulk: the
# MSM's running sums (64 lanes) and its Horner steps (2 lanes).
SMALL_WIDTHS = (64, 2)
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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from zkemail_tpu_torch.core import curve_torch as CT
    from zkemail_tpu_torch.core import field as F
    from zkemail_tpu_torch.core import limbs as LB
    from zkemail_tpu_torch.ops import field_kernels as FK
    from zkemail_tpu_torch.ops import kernel_build
    from zkemail_tpu_torch.ops.msm import fixed_base_batch, map_coords
    from zkemail_tpu_torch.prover.containers import verify
    from zkemail_tpu_torch.prover.groth16 import prove_batch
    from zkemail_tpu_torch.prover.setup import groth16_setup
    from zkemail_tpu_torch.scripts.synthetic_r1cs import make_circuit

    dev = torch.device("cuda")
    torch.set_grad_enabled(False)

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

    for name, kind, n, kern, plain in (
        ("ec_add_g1", "g1", 1 << 18, FK.ec_add_g1_flat, FK.ec_add_g1_plain),
        ("ec_add_g2", "g2", 1 << 16, FK.ec_add_g2_flat, FK.ec_add_g2_plain),
    ):
        p, q, neg = curve_operands(kind, n)
        err = check(name, kern, plain, p, q, neg)
        k_ms = time_ms(torch, lambda: kern(p, q, neg), 20)
        p_ms = time_ms(torch, lambda: plain(p, q, neg), 2)
        record(name, err, k_ms, p_ms, n, int(neg.sum()))
        log(f"  K {name} {n} lanes: equal; {k_ms:.4f} ms/launch, plain {p_ms:.3f} ms")
        width = SMALL_WIDTHS[0]
        for w in SMALL_WIDTHS:
            # every slice of w lanes of the first `width`: all edge lanes at w
            for lo in range(0, width, w):
                check(name, kern, plain, lanes(p, lo, lo + w), lanes(q, lo, lo + w),
                      neg[lo : lo + w].contiguous())
            ps, qs, ns = lanes(p, 0, w), lanes(q, 0, w), neg[:w].contiguous()
            results[name][f"ms_{w}"] = time_ms(torch, lambda: kern(ps, qs, ns), 200)
        log(f"  K {name} at " + ", ".join(
            f"{w} lanes: equal; {results[name][f'ms_{w}']:.4f} ms/launch"
            for w in SMALL_WIDTHS))
    del p, q, neg, ps, qs, ns, k, ref, a, b
    torch.cuda.empty_cache()
    log(f"phase 2 kernels vs plain: {time.time() - t0:.1f} s")

    def prove_and_verify(dims: dict, label: str, timers=None):
        t = time.time()
        circ = make_circuit(dims["n_constraints"], dims["n_signals"], seed=1)
        w = circ.witness(BATCH, seed=2)
        t_gen = time.time() - t
        t = time.time()
        pk = groth16_setup(circ.r1cs, seed=3, device=dev)
        torch.cuda.synchronize()
        t_setup = time.time() - t
        setup_launches = dict(FK.LAUNCHES)
        t = time.time()
        proofs = prove_batch(pk, circ.r1cs, w, rng=random.Random(4), timers=timers,
                             device=dev)
        t_prove = time.time() - t
        t = time.time()
        for proof, publics in proofs:
            if len(publics) != circ.r1cs.n_public:
                raise AssertionError(f"{label}: {len(publics)} publics")
            if not verify(pk.vk, proof, publics):
                raise AssertionError(f"{label}: a proof does not verify")
            bad = [(publics[0] + 1) % F.R] + publics[1:]
            if verify(pk.vk, proof, bad):
                raise AssertionError(f"{label}: a tampered public verifies")
        t_verify = time.time() - t
        return pk, {"gen_s": t_gen, "setup_s": t_setup, "prove_s": t_prove,
                    "verify_s": t_verify, "setup_launches": setup_launches}

    # -- 3. small end to end --------------------------------------------------
    t0 = time.time()
    pk, ts = prove_and_verify(SMALL, "small")
    log(f"phase 3 small e2e (2^{pk.domain_log2} domain, B={BATCH}): proofs verify, "
        f"tampered public refused; {json.dumps(ts)}; {time.time() - t0:.1f} s")
    del pk

    # -- 4. full width ---------------------------------------------------------
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    timers = {}
    FK.reset_launches()
    pk, ts = prove_and_verify(FULL640, "full", timers)
    launches = dict(FK.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 4 full width (2^{pk.domain_log2} domain, "
        f"{FULL640['n_signals']} signals, B={BATCH}): proofs verify, tampered "
        f"public refused; {json.dumps(ts)}; prove timers {json.dumps(timers)}; "
        f"launches {json.dumps(launches)}; peak {peak_gb:.1f} GB; "
        f"{time.time() - t0:.1f} s")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # -- 5. results ------------------------------------------------------------
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
            **{f"ms_{w}": r.get(f"ms_{w}") for w in SMALL_WIDTHS},
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
