"""Frozen outputs of the JAX package for the port's tests.

Several of the port's tests (tests/test_torch_*.py) hold it to outputs of
the JAX package (zkemail_tpu/) that come from fixed seeds: a Groth16 setup,
its proofs under a seeded random.Random, an eager MSM. The JAX package is
the reference and is never edited, so those outputs are the same bytes in
every run; this script computes them once, exactly as the tests computed
them, and writes them to tests/fixtures/jax_reference/, where the tests
read them (``read``, ``load_key``).

Each fixture is one .npz: its arrays, and under "meta" a JSON document of
plain ints (host points, publics) with the sha256 of every
zkemail_tpu/**/*.py and the jax version it was made from.
tests/test_torch_jax_reference.py fails, naming this script, once either
differs from the tree's. Regenerate with

    JAX_PLATFORMS=cpu python tests/make_jax_reference.py [name ...]

The files are written byte for byte the same on every run (fixed zip
timestamps, sorted entries)."""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "jax_reference"
QUERIES = ("a_query", "b1_query", "b2_query", "c_query", "h_query")
_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def source_hashes() -> dict:
    """{path under the repo: sha256} of every zkemail_tpu/**/*.py."""
    return {p.relative_to(ROOT).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "zkemail_tpu").rglob("*.py"))}


def jax_version() -> str:
    from importlib.metadata import version

    return version("jax")


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def write(name: str, arrays: dict, meta: dict) -> Path:
    """tests/fixtures/jax_reference/<name>.npz: the arrays (sorted by name)
    and meta with the provenance, as JSON bytes under "meta"."""
    meta = dict(meta, sources=source_hashes(), jax=jax_version())
    entries = dict(arrays, meta=np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8))
    FIXTURES.mkdir(parents=True, exist_ok=True)
    path = FIXTURES / f"{name}.npz"
    with zipfile.ZipFile(path, "w") as zf:
        for key in sorted(entries):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.ascontiguousarray(entries[key]),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(f"{key}.npy", date_time=_ZIP_TIME)
            info.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(info, buf.getvalue())
    return path


def read(name: str) -> tuple[dict, dict]:
    """(arrays, meta) of one fixture."""
    with np.load(FIXTURES / f"{name}.npz", allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, json.loads(arrays.pop("meta").tobytes())


def names() -> list:
    return sorted(p.stem for p in FIXTURES.glob("*.npz"))


# ---------------------------------------------------------------------------
# host points and keys as plain ints and arrays
# ---------------------------------------------------------------------------

def g1_ints(p):
    return None if p.inf else [int(p.x), int(p.y)]


def g2_ints(p):
    return None if p.inf else [[int(p.x.c0), int(p.x.c1)], [int(p.y.c0), int(p.y.c1)]]


def g1_point(v):
    """The JAX package's host G1 from g1_ints."""
    from zkemail_tpu.core.curve import G1

    return G1.identity() if v is None else G1(v[0], v[1])


def g2_point(v):
    from zkemail_tpu.core.curve import G2
    from zkemail_tpu.core.towers import Fq2

    return G2.identity() if v is None else G2(Fq2(*v[0]), Fq2(*v[1]))


def proofs_ints(proofs) -> list:
    return [[g1_ints(p.a), g2_ints(p.b), g1_ints(p.c), [int(x) for x in pub]]
            for p, pub in proofs]


def proofs_from(rows) -> list:
    """[(Proof, publics)] as the JAX prove_batch returns them."""
    from zkemail_tpu.prover.containers import Proof

    return [(Proof(g1_point(a), g2_point(b), g1_point(c)), list(pub))
            for a, b, c, pub in rows]


def points_ints(points) -> list:
    """The five pre-blinding host point lists (a, b2, b1, c, h)."""
    return [[(g2_ints if i == 1 else g1_ints)(p) for p in pts]
            for i, pts in enumerate(points)]


def points_from(rows) -> tuple:
    return tuple([(g2_point if i == 1 else g1_point)(v) for v in pts]
                 for i, pts in enumerate(rows))


def key_parts(pk) -> tuple[dict, dict]:
    """A JAX ProvingKey -> (arrays, meta): its query tables as int32 arrays
    named query.coord[.component], the rest as ints."""
    arrays = {}
    for q in QUERIES:
        for k, v in getattr(pk, q).items():
            if isinstance(v, tuple):
                for i, c in enumerate(v):
                    arrays[f"{q}.{k}.{i}"] = np.asarray(c)
            else:
                arrays[f"{q}.{k}"] = np.asarray(v)
    vk = pk.vk
    meta = {
        "domain_log2": pk.domain_log2, "n_public": pk.n_public,
        "n_constraints": pk.n_constraints,
        "alpha_g1": g1_ints(pk.alpha_g1), "beta_g1": g1_ints(pk.beta_g1),
        "delta_g1": g1_ints(pk.delta_g1), "beta_g2": g2_ints(pk.beta_g2),
        "delta_g2": g2_ints(pk.delta_g2),
        "vk": {"alpha_g1": g1_ints(vk.alpha_g1), "beta_g2": g2_ints(vk.beta_g2),
               "gamma_g2": g2_ints(vk.gamma_g2), "delta_g2": g2_ints(vk.delta_g2),
               "ic": [g1_ints(p) for p in vk.ic]},
    }
    return arrays, meta


def key_from(arrays: dict, meta: dict):
    """The JAX ProvingKey of key_parts, its tables numpy arrays (as the JAX
    package's load_chunked gives them)."""
    from zkemail_tpu.prover.containers import VerifyingKey
    from zkemail_tpu.prover.setup import ProvingKey

    queries = {q: {} for q in QUERIES}
    for name in sorted(arrays):
        q, _, rest = name.partition(".")
        if q not in queries:
            continue
        k, *comp = rest.split(".")
        if comp:
            queries[q].setdefault(k, []).append(arrays[name])
        else:
            queries[q][k] = arrays[name]
    for q in queries.values():
        for k, v in q.items():
            if isinstance(v, list):
                q[k] = tuple(v)
    vk = meta["vk"]
    return ProvingKey(
        domain_log2=meta["domain_log2"], n_public=meta["n_public"],
        n_constraints=meta["n_constraints"],
        alpha_g1=g1_point(meta["alpha_g1"]), beta_g1=g1_point(meta["beta_g1"]),
        beta_g2=g2_point(meta["beta_g2"]), delta_g1=g1_point(meta["delta_g1"]),
        delta_g2=g2_point(meta["delta_g2"]),
        vk=VerifyingKey(alpha_g1=g1_point(vk["alpha_g1"]), beta_g2=g2_point(vk["beta_g2"]),
                        gamma_g2=g2_point(vk["gamma_g2"]), delta_g2=g2_point(vk["delta_g2"]),
                        ic=[g1_point(p) for p in vk["ic"]]),
        **queries)


def load_key(name: str):
    return key_from(*read(name))


# ---------------------------------------------------------------------------
# the fixtures, computed as the tests computed them
# ---------------------------------------------------------------------------

def _toy_prove(cc, pk, xs, seed):
    """The JAX witness of the toy for xs, and the JAX prove_batch's proofs
    under random.Random(seed) and its five pre-blinding points."""
    import random

    import jax.numpy as jnp
    from zkemail_tpu.prover import groth16 as JG

    w = np.asarray(cc.eval_witness({"x": jnp.asarray(xs, dtype=jnp.int32)}, len(xs)))
    store = {}
    orig = JG._results_to_host

    def wrapped(*args, **kwargs):
        store["points"] = orig(*args, **kwargs)
        return store["points"]

    JG._results_to_host = wrapped
    try:
        proofs = JG.prove_batch(pk, cc, jnp.asarray(w), rng=random.Random(seed))
    finally:
        JG._results_to_host = orig
    return w, proofs, store["points"]


def make_toy() -> list:
    """The toy of tests/test_torch_prover.py: the JAX key (seed 42); the
    witness for XS, the JAX proofs under Random(7) and the five
    pre-blinding points (test_torch_prover.py); the witness for BATCH, the
    JAX proofs under Random(42) and h_ref, the JAX unsharded NTT pair of
    the 4-rank run's sharded_h_eval input (test_torch_parallel.py)."""
    import jax.numpy as jnp
    import test_torch_parallel as TPAR
    import test_torch_prover as TPR
    from zkemail_tpu.ops import ntt as JNTT
    from zkemail_tpu.prover.setup import groth16_setup as jax_setup

    cc = TPR.build_toy()
    pk = jax_setup(cc, seed=42)
    out = [write("toy_key_seed42", *key_parts(pk))]
    w, proofs, points = _toy_prove(cc, pk, TPR.XS, 7)
    out.append(write("toy_prove_seed7", {"w": w},
                     {"xs": TPR.XS, "proofs": proofs_ints(proofs),
                      "points": points_ints(points)}))
    w, proofs, _ = _toy_prove(cc, pk, TPAR.BATCH, 42)
    x = TPAR.h_eval_values()
    h_ref = np.asarray(JNTT.shifted_ntt(JNTT.ntt(jnp.asarray(x), inverse=True)))
    out.append(write("toy_prove_seed42", {"w": w, "h_ref": h_ref},
                     {"xs": TPAR.BATCH, "proofs": proofs_ints(proofs)}))
    return out


def make_zkeytoy() -> list:
    """The toy of tests/test_torch_artifacts.py: the JAX key (seed 9) and
    its .zkey bytes, with and without the circuit's coefficients."""
    import test_torch_artifacts as TA
    from zkemail_tpu.circuits.builder import ConstraintSystem as JCS
    from zkemail_tpu.prover import zkey as JZ
    from zkemail_tpu.prover.setup import groth16_setup as jax_setup

    jcc = TA.toy(JCS)
    pk = jax_setup(jcc, seed=9)
    arrays, meta = key_parts(pk)
    arrays["zkey"] = np.frombuffer(JZ.write_zkey(pk, jcc), dtype=np.uint8)
    arrays["zkey_bare"] = np.frombuffer(JZ.write_zkey(pk), dtype=np.uint8)
    return [write("zkeytoy_key_seed9", arrays, meta)]


def make_msm_sort() -> list:
    """The JAX msm_sorted at c = 13 and msm_sorted_pruned at c = 8 of
    tests/test_torch_msm_sort.py (test_msm_sorted_c13_equals_jax_and_host,
    test_msm_sorted_pruned_equals_dense_and_jax), as affine host ints."""
    import jax.numpy as jnp
    import test_torch_msm_sort as TMS
    from zkemail_tpu.core import curve_jax as CJ
    from zkemail_tpu.ops import msm_sort as JS

    _, pts, _, limbs = TMS.c13_case()
    ref = JS.msm_sorted(CJ.FQ_OPS, TMS._jax_points(pts), jnp.asarray(limbs), c_bits=13,
                        k_block=4, cutoff=4)
    points = [g1_ints(p) for p in TMS._jax_to_host(CJ.FQ_OPS, ref)]
    out = [write("msm_sorted_c13", {}, {"points": points})]
    _, _, _, limbs, _, perm, prefixes, pts_p = TMS.pruned_case()
    ref = JS.msm_sorted_pruned(CJ.FQ_OPS, TMS._jax_points(pts_p), jnp.asarray(limbs),
                               perm.numpy().astype(np.int32), prefixes, c_bits=8, k_block=4)
    points = [g1_ints(p) for p in TMS._jax_to_host(CJ.FQ_OPS, ref)]
    out.append(write("msm_sorted_pruned_c8", {}, {"points": points}))
    return out


def make_msm() -> list:
    """The JAX msm_multi of tests/test_torch_msm.py::
    test_msm_multi_equals_jax_and_host, as its affine limbs' ints."""
    import jax.numpy as jnp
    import test_torch_msm as TM
    from zkemail_tpu.core import curve_jax as CJ
    from zkemail_tpu.ops import msm as JM

    _, jpts, _, limbs = TM.msm_multi_case()
    coords, inf = TM._affine_ints(CJ, CJ.FQ_OPS, JM.msm_multi(CJ.FQ_OPS, jpts, jnp.asarray(limbs)))
    affine = [[[int(v) for v in c] for c in coords], [bool(v) for v in inf]]
    return [write("msm_multi_n150", {}, {"affine": affine})]


def make_curve_double() -> list:
    """The JAX ec_scalar_mul_bits of tests/test_torch_curve_double.py::
    test_ec_scalar_mul_bits_equals_jax, affine."""
    import jax.numpy as jnp
    import test_torch_curve_double as TCD
    from zkemail_tpu.core import curve_jax as CJ

    _, jp, _, bits = TCD.scalar_mul_case()
    aff = CJ.ec_to_affine(CJ.FQ_OPS, CJ.ec_scalar_mul_bits(CJ.FQ_OPS, jp, jnp.asarray(bits)))
    return [write("ec_scalar_mul_bits_g1", {k: np.asarray(v) for k, v in aff.items()}, {})]


def make_poseidon() -> list:
    """poseidon_jax of tests/test_torch_poseidon_batch.py::
    test_poseidon_torch_equals_jax, at n = 2 and 9 inputs."""
    import jax.numpy as jnp
    import test_torch_poseidon_batch as TPB
    from zkemail_tpu.core.poseidon_jax import poseidon_jax

    arrays = {f"n{n}": np.asarray(poseidon_jax(jnp.asarray(TPB._mont_inputs(n, 10 + n)[0])))
              for n in (2, 9)}
    return [write("poseidon_jax_b8", arrays, {})]


MAKERS = {"toy": make_toy, "zkeytoy": make_zkeytoy, "msm_sort": make_msm_sort,
          "msm": make_msm, "curve_double": make_curve_double, "poseidon": make_poseidon}


def main(argv: list) -> None:
    # the JAX configuration of tests/conftest.py
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    for name in argv or sorted(MAKERS):
        for path in MAKERS[name]():
            print(f"{path.relative_to(ROOT)}: {path.stat().st_size} bytes, sha256 "
                  f"{hashlib.sha256(path.read_bytes()).hexdigest()}")


if __name__ == "__main__":
    main(sys.argv[1:])
