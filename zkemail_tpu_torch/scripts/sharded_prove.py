"""The multi-GPU prove: the body every rank runs, and its full-width check.

    python -m zkemail_tpu_torch.scripts.sharded_prove

builds the full640 EmailVerifier, signs two emails with a seeded key,
computes their witness and a key (setup seed 3) on cuda:0 and proves them
there under ``random.Random(4)``: the reference (proved once more, warm and
timed, for comparison in the same run). It writes the key (chunked
artifacts), the circuit and the witness to a temporary directory and proves
the batch again on meshes of every card (``mesh_configs``): with N >= 2
cards NCCL over N ranks at ``make_mesh(N)`` and at (1, N); with one card
NCCL at world size 1, then two gloo ranks sharing the card at (1, 2). Every
mesh's proofs, on every rank, must equal the reference bit for bit, verify
and refuse a tampered public; one line per mesh gives its stage times,
gather seconds, kernel launches and peak device memory per rank. Exits
non-zero on any failure; a failed process group or gather is a failure.

``rank_job`` is the rank body: ``parallel/launch.py::spawn`` runs it in
each child, for this script and for ``chip_smoke.py`` phase 8
(``scripts/mesh_checks.py`` adds the sharded NTT and MSM to it). It
imports no JAX.
"""

from __future__ import annotations

import json
import pickle
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core import field as F
from ..core import limbs as LB
from ..ops import field_kernels as FK
from ..parallel.launch import spawn
from ..parallel.sharding import axis_size, make_mesh, mesh_shape
from ..prover.artifacts import export_chunked, load_chunked
from ..prover.containers import verify
from ..prover.convert import proving_key_from_arrays, r1cs_from_arrays
from ..prover.groth16 import _prove_consts, prove_batch

SEED = 4  # the rng seed of the reference proofs


def _rank_device(kind: str) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load(obj):
    """An object given inline, or by the path of a file this module wrote
    (.npy arrays, .pkl pickles)."""
    if not isinstance(obj, (str, Path)):
        return obj
    if str(obj).endswith(".npy"):
        return np.load(obj)
    with open(obj, "rb") as f:
        return pickle.load(f)


def _load_key(spec: dict, dev: torch.device):
    if "chunked" in spec:
        return load_chunked(spec["chunked"], spec["name"], device=dev)
    return proving_key_from_arrays(**spec["arrays"], device=dev)


def _prove_on(mesh, pk, cc, w, seed: int, dev: torch.device) -> dict:
    """prove_batch on `mesh` under random.Random(seed), with the kernel
    launches counted from 0 and the peak device memory of this rank."""
    _sync(dev)
    FK.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timers = {}
    t = time.time()
    proofs = prove_batch(pk, cc, w, rng=random.Random(seed), timers=timers, device=dev,
                         mesh=mesh)
    _sync(dev)
    return {
        "proofs": proofs, "prove_s": time.time() - t, "timers": timers,
        "launches": dict(FK.LAUNCHES),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def load_prove_job(prove: dict, dev: torch.device) -> tuple:
    """(pk, cc, w, load_s) of a job's "prove" part: the key, the circuit and
    the witness loaded onto dev and the matrices uploaded (_prove_consts),
    load_s the seconds of all that."""
    t = time.time()
    pk = _load_key(prove["key"], dev)
    cc = _load(prove["circuit"])
    w = LB.to_device(_load(prove["witness"]), dev)
    _prove_consts(cc, pk)
    _sync(dev)
    return pk, cc, w, time.time() - t


def mesh_coords(mesh) -> dict:
    """The mesh's "shape" (dp, msm) and this rank's "coords" on it."""
    return {"shape": (axis_size(mesh, "dp"), axis_size(mesh, "msm")),
            "coords": (mesh.get_local_rank("dp"), mesh.get_local_rank("msm"))}


def prove_on_mesh(mesh, pk, cc, w, prove: dict, load_s: float) -> dict:
    """prove_batch(mesh=) under random.Random(prove["seed"]), prove["runs"]
    times (default 1; every run's proofs must be equal): the last run's
    proofs, timers, launches and peak memory, the first run's seconds
    (cold_s: the mesh's query slices and NTT tables are made then) and
    load_s."""
    dev = pk.device
    runs = [_prove_on(mesh, pk, cc, w, prove["seed"], dev)
            for _ in range(prove.get("runs", 1))]
    if any(proof_keys(r["proofs"]) != proof_keys(runs[0]["proofs"]) for r in runs):
        raise AssertionError(f"mesh {mesh_coords(mesh)['shape']}: two runs gave "
                             "different proofs")
    return dict(runs[-1], cold_s=runs[0]["prove_s"], load_s=load_s)


def rank_job(rank: int, world: int, job: dict) -> list:
    """What one rank does: load job["prove"] {"key", "circuit", "witness",
    "seed", "runs"} once (load_prove_job), then for each dp of
    job["meshes"] (None: make_mesh's default) build the (dp, world / dp)
    mesh and prove on it (prove_on_mesh). job["device"] is "cpu" or "cuda"
    (the rank's current card) and job["backend"] the backend make_mesh is
    told to expect. Returns one dict per mesh: its mesh_coords and
    "prove"."""
    dev = _rank_device(job["device"])
    pk, cc, w, load_s = load_prove_job(job["prove"], dev)
    out = []
    for dp in job["meshes"]:
        mesh = make_mesh(world, dp=dp, device_type=dev.type, backend=job["backend"])
        out.append(dict(mesh_coords(mesh),
                        prove=prove_on_mesh(mesh, pk, cc, w, job["prove"], load_s)))
    return out


# ---------------------------------------------------------------------------
# the check: proofs on every mesh against the single-card reference
# ---------------------------------------------------------------------------

def write_job_files(tmp: Path, cc, w: torch.Tensor, key_dir: Path, key_name: str) -> dict:
    """The "prove" part of a job for a key already exported by
    export_chunked into key_dir: the circuit's matrices (pickled R1CS) and
    the witness (.npy) are written to tmp."""
    circuit = tmp / "circuit.pkl"
    with open(circuit, "wb") as f:
        pickle.dump(r1cs_from_arrays(name=cc.name, A=cc.A, B=cc.B, C=cc.C,
                                     n_constraints=cc.n_constraints,
                                     n_signals=cc.n_signals, n_public=cc.n_public), f)
    witness = tmp / "witness.npy"
    np.save(witness, w.cpu().numpy())
    return {"key": {"chunked": str(key_dir), "name": key_name},
            "circuit": str(circuit), "witness": str(witness), "seed": SEED, "runs": 2}


def mesh_configs(n_cards: int) -> list:
    """(backend, world size, [dp of each mesh]) to run on n_cards cards:
    NCCL over every card at make_mesh's default and at (1, n); on one
    card NCCL at world size 1 and two gloo ranks sharing it at (1, 2)."""
    if n_cards >= 2:
        return [("nccl", n_cards, [None, 1] if mesh_shape(n_cards)[0] > 1 else [1])]
    return [("nccl", 1, [1]), ("gloo", 2, [1])]


def proof_keys(proofs) -> list:
    """prove_batch's proofs as comparable tuples (a, b, c, publics)."""
    return [(pr.a, pr.b, pr.c, tuple(pub)) for pr, pub in proofs]


def run_meshes(prove_job: dict, n_cards: int, reference: list, vk, head: str,
               log=print, timeout_s: float = 600.0) -> dict:
    """Prove prove_job on every mesh of mesh_configs(n_cards); each mesh's
    proofs on every rank must equal `reference` (proof_keys of the single
    card's), verify under vk and refuse a tampered public, and every rank
    must launch K1, K2 and K3. Logs one line per mesh, headed with `head`:
    per rank the load, the first (cold) and the last prove's seconds, the
    last prove's stage timers, launches and peak memory. Returns the
    last proves' launches summed over ranks and meshes."""
    want = list(reference)
    total = dict.fromkeys(FK.LAUNCHES, 0)
    for backend, world, meshes in mesh_configs(n_cards):
        job = {"device": "cuda", "backend": backend, "meshes": meshes, "prove": prove_job}
        t = time.time()
        ranks = spawn(rank_job, world, backend=backend, args=(job,), timeout_s=timeout_s)
        wall = time.time() - t
        for i in range(len(meshes)):
            per = [r[i] for r in ranks]
            shape = per[0]["shape"]
            for r, res in enumerate(per):
                if proof_keys(res["prove"]["proofs"]) != want:
                    raise AssertionError(f"mesh {shape} on {backend}: rank {r}'s proofs "
                                         "differ from the single-card proofs")
                idle = [k for k, v in res["prove"]["launches"].items() if v == 0]
                if idle:
                    raise AssertionError(f"mesh {shape} on {backend}: rank {r} did not "
                                         f"launch {idle}")
                for k, v in res["prove"]["launches"].items():
                    total[k] += v
            for proof, publics in per[0]["prove"]["proofs"]:
                if not verify(vk, proof, publics):
                    raise AssertionError(f"mesh {shape}: a proof does not verify")
                if verify(vk, proof, [(publics[0] + 1) % F.R] + publics[1:]):
                    raise AssertionError(f"mesh {shape}: a tampered public verifies")
            rows = [{"rank": r, "load_s": round(res["prove"]["load_s"], 3),
                     "cold_s": round(res["prove"]["cold_s"], 3),
                     "prove_s": round(res["prove"]["prove_s"], 3),
                     **res["prove"]["timers"],
                     "gather_s": round(res["prove"]["timers"]["gather_s"], 3),
                     "launches": res["prove"]["launches"],
                     "peak_gb": round(res["prove"]["peak_bytes"] / 1e9, 2)}
                    for r, res in enumerate(per)]
            log(f"{head} | mesh (dp, msm) = {tuple(shape)} on {backend}, world {world}: "
                f"proofs equal the single card's on every rank, verify, tampered public "
                f"refused; spawn wall {wall:.1f} s; per rank {json.dumps(rows)}")
    return total


def email_reference(dev: torch.device):
    """The full640 EmailVerifier on two emails signed by a seeded key, as
    chip_smoke.py phase 5: (compiled circuit, witness, key, proofs under
    random.Random(SEED), the prove's stage timers)."""
    from ..helpers.input_gen import InputGenArgs, generate_email_verifier_inputs
    from ..helpers.testkit import LocalDKIMSigner
    from ..models.email_verifier import EmailVerifierConfig, build_email_verifier
    from ..models.input_bridge import prepare_inputs
    from ..prover.setup import groth16_setup

    signer = LocalDKIMSigner(seed=2026)
    emails = [
        signer.sign_email(subject="Full-width proof, email one",
                          body=b"The first email proved on the card.\r\n"),
        signer.sign_email(subject="Email two", to="carol@example.net",
                          body=b"A second body,\r\nwith two lines.\r\n"),
    ]
    cfg = EmailVerifierConfig(max_headers_length=640, max_body_length=768)
    args = InputGenArgs(max_headers_length=640, max_body_length=768)
    raws = [generate_email_verifier_inputs(e, signer.resolver(), args) for e in emails]
    cc = build_email_verifier(cfg).cs.compile()
    w = cc.eval_witness(prepare_inputs(raws, cfg, device=dev), len(emails), device=dev)
    pk = groth16_setup(cc, seed=3, device=dev)
    timers = {}
    proofs = prove_batch(pk, cc, w, rng=random.Random(SEED), timers=timers, device=dev)
    return cc, w, pk, proofs, timers


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_prove: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    n = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    t = time.time()
    cc, w, pk, proofs, timers = email_reference(dev)
    print(f"{card} | {n} cards; full640 reference on cuda:0 (build, witness, setup, "
          f"prove): {time.time() - t:.1f} s", flush=True)
    t = time.time()
    if proof_keys(prove_batch(pk, cc, w, rng=random.Random(SEED), timers=timers,
                              device=dev)) != proof_keys(proofs):
        raise AssertionError("two single-card proves gave different proofs")
    print(f"{card} | single-card prove_batch, warm: {time.time() - t:.3f} s; timers "
          f"{json.dumps(timers)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="sharded_prove_") as tmp:
        tmp = Path(tmp)
        export_chunked(pk, tmp / "key", name="full640")
        job = write_job_files(tmp, cc, w, tmp / "key", "full640")
        vk = pk.vk
        del pk
        torch.cuda.empty_cache()
        total = run_meshes(job, n, proof_keys(proofs), vk, card,
                           log=lambda s: print(s, flush=True))
    print(json.dumps({"ok": True, "cards": n, "launches_sharded_prove": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
