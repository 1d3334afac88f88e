"""A tiny cell for the tests: the header_digest circuit under a mix of
pairs of emails, in a data root that copies proofbench's own files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from proofbench import harness as H

E2E = [{"name": "proofs_per_s", "unit": "proofs/s"}, {"name": "setup_s", "unit": "s"}]
PER_LAYER = ["inputs_s.batch", "witness_s.batch", "prove_s.batch", "h_stage_s.batch",
             "msm_s.batch", "plan_hit_share.batch", "device_idle.batch", "peak_mem_gb.batch"]


def make_root(tmp: Path, mesh=None, batch: int = 2) -> tuple[dict, Path]:
    """(bench, root) of the cell "toy.pair" (and its config file) under tmp."""
    root = tmp / "root"
    for d in ("circuits", "metrics", "traffic"):
        shutil.copytree(H.HERE / d, root / d, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((H.HERE / "traffic" / "b8_short.json").read_text())
    (root / "traffic" / "pair.json").write_text(json.dumps(dict(mix, batch=batch)))
    cfg = {"name": "toy", "circuit": "header_digest", "n_constraints": 514, "n_signals": 515,
           "domain_log2": 10, "publics": ["sha_hi", "sha_lo"], "setup_seed": 5}
    if mesh:
        cfg["mesh"] = list(mesh)
    (tmp / "toy.json").write_text(json.dumps(cfg))
    bench = {"configs": [{"name": "toy", "file": str(tmp / "toy.json")}],
             "workloads": [{"name": "toy.pair", "config": "toy", "traffic": "pair", "chips": 1}],
             "end_to_end": E2E,
             "per_layer": [{"name": n, "unit": "s", "moves": "proofs_per_s"} for n in PER_LAYER]}
    return bench, root
