"""The sharded NTT and the sharded sort MSM on every rank of a mesh, beside
the sharded prove: the rank body that holds them to one rank's results.

``check_job`` runs under ``parallel/launch.py::spawn`` (the CPU tests of
``tests/test_torch_parallel.py`` run it on four gloo ranks). For each mesh
it runs the parts the job holds and returns their results, for the caller
to compare with the unsharded functions on the same inputs. It imports no
JAX, so the ranks never do.
"""

from __future__ import annotations

import random

import torch

from ..core import curve_torch as CT
from ..parallel.sharding import make_mesh, sharded_h_eval, sharded_sort_msm
from ..prover.groth16 import prove_batch
from .sharded_prove import _rank_device, load_prove_job, mesh_coords, prove_on_mesh


def affine_ints(ops, pt: dict) -> list:
    """A point batch (B,) -> per batch element (x, y, inf), each coordinate
    a tuple of ints (one for G1, (c0, c1) for G2)."""
    aff = CT.ec_to_affine(ops, pt)

    def ints(c):
        cs = c if isinstance(c, tuple) else (c,)
        return list(zip(*[[int(v) for v in CT.FQ_OPS.to_ints(x)] for x in cs]))

    return list(zip(ints(aff["x"]), ints(aff["y"]), aff["inf"].cpu().tolist()))


def _tensors(obj, dev: torch.device):
    if isinstance(obj, dict):
        return {k: _tensors(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_tensors(v, dev) for v in obj)
    return torch.as_tensor(obj, device=dev)


def check_job(rank: int, world: int, job: dict) -> list:
    """For each dp of job["meshes"] (None: make_mesh's default) build the
    (dp, world / dp) mesh and run the job's parts on it, the first two only
    where msm > 1 (at msm = 1 they are the unsharded functions):

      * "h_eval" {"log_m", "values" (L, m, B) Montgomery}: sharded_h_eval of
        this rank's block -> "h_eval" (the block, numpy);
      * "sort_msm" {"g2", "points", "scalars", "c_bits", "k_block"}: the
        full points and scalars through sharded_sort_msm -> "sort_msm"
        (affine_ints);
      * "prove" (as scripts/sharded_prove.py::rank_job's, loaded once)
        -> "prove" (prove_on_mesh); with "divisible", a batch of dp + 1 on
        a mesh with dp > 1 as well -> "divisible" (the error raised).

    job["device"] and job["backend"] as in rank_job. Returns one dict per
    mesh: its mesh_coords and the parts' results."""
    dev = _rank_device(job["device"])
    prove = job.get("prove")
    if prove is not None:
        pk, cc, w, load_s = load_prove_job(prove, dev)
    out = []
    for dp in job["meshes"]:
        mesh = make_mesh(world, dp=dp, device_type=dev.type, backend=job["backend"])
        res = mesh_coords(mesh)
        (dp, S), idx = res["shape"], res["coords"][1]
        if "h_eval" in job and S > 1:
            spec = job["h_eval"]
            m2 = spec["values"].shape[1] // S
            blk = torch.as_tensor(spec["values"][:, idx * m2 : (idx + 1) * m2], device=dev)
            res["h_eval"] = sharded_h_eval(mesh, blk, spec["log_m"]).cpu().numpy()
        if "sort_msm" in job and S > 1:
            spec = job["sort_msm"]
            ops = CT.FQ2_OPS if spec["g2"] else CT.FQ_OPS
            got = sharded_sort_msm(mesh, ops, _tensors(spec["points"], dev),
                                   _tensors(spec["scalars"], dev),
                                   c_bits=spec["c_bits"], k_block=spec["k_block"])
            res["sort_msm"] = affine_ints(ops, got)
        if prove is not None:
            res["prove"] = prove_on_mesh(mesh, pk, cc, w, prove, load_s)
            if job.get("divisible") and dp > 1:
                try:
                    prove_batch(pk, cc, w[:, :, :1].expand(-1, -1, dp + 1),
                                rng=random.Random(prove["seed"]), device=dev, mesh=mesh)
                except ValueError as exc:
                    res["divisible"] = str(exc)
        out.append(res)
    return out
