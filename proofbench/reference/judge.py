"""The plain reference that decides ``correct``: it judges every proof the
run produced after set-up, from the emails the benchmark signed and the
setup seed, and from nothing the program computed.

* Publics: each email's expected public signals, worked out here: the
  Poseidon hash of the signing key's modulus (zk-email's PoseidonLarge)
  and the header's SHA-256 digest (the DKIM signature base the benchmark
  signed) as two 128-bit halves, in the circuit's order.
* Proofs: each proof is checked by the Groth16 pairing equation against a
  verifying key worked out here: the toxic waste tau, alpha, beta, gamma,
  delta drawn from ``random.Random(setup_seed)`` as the setup draws them,
  and the public columns of the circuit's R1CS (the statement being proved)
  evaluated at tau over the radix-2 domain. With the toxic waste known,
  e(alpha, beta) e(IC, gamma) e(C, delta) is e(s G1 + delta C, G2) with
  s = alpha beta + sum_i x_i (beta u_i + alpha v_i + w_i)(tau), so a proof
  costs one Miller loop and all proofs share one final exponentiation
  (a random linear combination; on a failure each proof is checked alone).

Every count is an exact comparison: its limit is 0.
"""

from __future__ import annotations

import functools
import hashlib
import random

from . import bn254 as B
from .poseidon import poseidon_large

R = B.R
FR_TWO_ADICITY = 28
FR_ROOT_OF_UNITY = pow(5, (R - 1) >> FR_TWO_ADICITY, R)  # order 2^28

LIMITS = {"unanswered": 0, "publics_wrong": 0, "proofs_rejected": 0, "circuit_size_off": 0}


def toxic_waste(setup_seed: int) -> dict:
    """tau, alpha, beta, gamma, delta in the setup's order of draws."""
    if not setup_seed:
        raise ValueError("a setup seed of 0 draws from the system's entropy")
    rng = random.Random(setup_seed)
    return {k: rng.randrange(1, R) for k in ("tau", "alpha", "beta", "gamma", "delta")}


def domain_log2(n_rows: int) -> int:
    """The smallest radix-2 domain over n_rows rows (at least 2)."""
    return max(1, (max(n_rows, 2) - 1).bit_length())


def lagrange_at(tau: int, log_m: int, rows: list[int]) -> dict:
    """{j: L_j(tau)} over the domain of size 2^log_m, L_j(tau) =
    Z(tau) w^j / (m (tau - w^j)), by one batch inversion."""
    m = 1 << log_m
    w = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - log_m), R)
    rows = sorted(set(rows))
    pows, prev, cur = [], 0, 1
    for j in rows:
        cur = cur * pow(w, j - prev, R) % R
        pows.append(cur)
        prev = j
    dens = [(tau - x) % R for x in pows]
    prefix, acc = [], 1
    for d in dens:
        prefix.append(acc)
        acc = acc * d % R
    inv = pow(acc, -1, R)
    scale = (pow(tau, m, R) - 1) * pow(m, -1, R) % R
    out = {}
    for i in range(len(rows) - 1, -1, -1):
        inv_d = inv * prefix[i] % R
        inv = inv * dens[i] % R
        out[rows[i]] = scale * pows[i] % R * inv_d % R
    return out


def public_scalars(statement: dict) -> list[int]:
    """k_i = beta u_i(tau) + alpha v_i(tau) + w_i(tau) for i = 0..n_public
    (signal 0 is the constant one).

    statement: setup_seed, n_constraints, n_public and "entries": {"A", "B",
    "C": [(row, col, coeff)] of the columns 0..n_public}. The A matrix gets
    the instance rows n_constraints + i carrying public i, as the Groth16
    QAP appends them."""
    tw = toxic_waste(statement["setup_seed"])
    n_c, n_pub = statement["n_constraints"], statement["n_public"]
    log_m = domain_log2(n_c + n_pub + 1)
    ents = {k: list(v) for k, v in statement["entries"].items()}
    ents["A"] += [(n_c + i, i, 1) for i in range(n_pub + 1)]
    lag = lagrange_at(tw["tau"], log_m, [r for v in ents.values() for r, _, _ in v])
    cols = {}
    for which in ("A", "B", "C"):
        acc = [0] * (n_pub + 1)
        for r, c, cf in ents[which]:
            acc[c] += cf * lag[r]
        cols[which] = [a % R for a in acc]
    return [(tw["beta"] * u + tw["alpha"] * v + w) % R
            for u, v, w in zip(cols["A"], cols["B"], cols["C"])]


def expected_publics(names: list[str], email: dict) -> list[int]:
    """The public signals of one email, by their names in the config."""
    digest = email["header_digest"]
    values = {
        "pubkey_hash": lambda: _pubkey_hash(email["modulus"]),
        "sha_hi": lambda: int.from_bytes(digest[:16], "big"),
        "sha_lo": lambda: int.from_bytes(digest[16:], "big"),
    }
    return [values[n]() for n in names]


@functools.lru_cache(maxsize=64)
def _pubkey_hash(modulus: int) -> int:
    return poseidon_large(modulus)


def _g1(p) -> B.G1:
    x, y, inf = p
    return B.G1_ZERO if inf else B.G1(x % B.Q, y % B.Q)


def _g2(p) -> B.G2:
    (x0, x1), (y0, y1), inf = p
    return B.G2_ZERO if inf else B.G2(B.Fq2(x0 % B.Q, x1 % B.Q), B.Fq2(y0 % B.Q, y1 % B.Q))


def _pairs(proof: dict, publics: list[int], ks: list[int], delta: int, alpha_beta: int,
           rho: int):
    """The two pairing arguments of rho * (one proof's equation), or None when
    a point is off its curve or B is outside G2's subgroup."""
    a, b, c = _g1(proof["a"]), _g2(proof["b"]), _g1(proof["c"])
    if not (a.on_curve() and c.on_curve() and b.on_curve() and b.in_subgroup()):
        return None
    s = (alpha_beta + ks[0] + sum(x * k for x, k in zip(publics, ks[1:]))) % R
    rhs = B.G1_GEN.mul(s).add(c.mul(delta))
    return (a.mul(rho), b), rhs.mul(rho)


def judge(statement: dict, public_names: list[str], emails: list[dict],
          answers: list, check_seed: int, circuit_size: tuple) -> dict:
    """The counts that decide ``correct``, each to be held to LIMITS, and
    "bad": the requests that failed any of them.

    emails: what the benchmark signed, one per request ("modulus",
    "header_digest"); answers: per request None (no proof came) or
    {"publics": [int], "a": (x, y, inf), "b": ((x0, x1), (y0, y1), inf),
    "c": (x, y, inf)}; circuit_size: (constraints, signals, domain log2)
    built, and configured."""
    tw = toxic_waste(statement["setup_seed"])
    ks = public_scalars(statement)
    alpha_beta = tw["alpha"] * tw["beta"] % R
    rng = random.Random(hashlib.sha256(f"judge:{check_seed}".encode()).digest())
    unanswered = publics_wrong = rejected = 0
    bad, lhs, rhs_sum, singles = set(), [], B.G1_ZERO, []
    for i, (email, ans) in enumerate(zip(emails, answers)):
        if ans is None:
            unanswered += 1
            bad.add(i)
            continue
        want = expected_publics(public_names, email)
        if list(ans["publics"]) != want:
            publics_wrong += 1
            bad.add(i)
        pr = _pairs(ans, want, ks, tw["delta"], alpha_beta, rng.getrandbits(128) | 1)
        if pr is None:
            rejected += 1
            bad.add(i)
            continue
        singles.append((i, ans, want))
        lhs.append(pr[0])
        rhs_sum = rhs_sum.add(pr[1])
    if singles and not B.pairing_product_is_one(lhs + [(rhs_sum.neg(), B.G2_GEN)]):
        for i, ans, want in singles:
            a_b, rhs = _pairs(ans, want, ks, tw["delta"], alpha_beta, 1)
            if not B.pairing_product_is_one([a_b, (rhs.neg(), B.G2_GEN)]):
                rejected += 1
                bad.add(i)
    built, configured = circuit_size
    return {
        "unanswered": unanswered,
        "publics_wrong": publics_wrong,
        "proofs_rejected": rejected,
        "circuit_size_off": sum(abs(x - y) for x, y in zip(built, configured)),
        "bad": sorted(bad),
    }
