"""Cells and metrics are data: a configuration, a traffic mix and a metric
added as files are found by their names, with no edit to code."""

import json

from proofbench import harness as H
from proofbench.tests.toycell import make_root


def test_added_config_mix_and_metric_are_found(tmp_path):
    bench, root = make_root(tmp_path)
    (root / "traffic" / "trio.json").write_text(json.dumps(
        dict(json.loads((root / "traffic" / "pair.json").read_text()), batch=3)))
    (root / "metrics" / "emails_per_batch.py").write_text(
        "def read(run):\n    return run['batches'][0]['requests']\n")
    cfg = json.loads((tmp_path / "toy.json").read_text())
    (tmp_path / "toy2.json").write_text(json.dumps(dict(cfg, name="toy2", setup_seed=6)))
    bench["configs"].append({"name": "toy2", "file": str(tmp_path / "toy2.json")})
    bench["workloads"].append({"name": "toy2.trio", "config": "toy2", "traffic": "trio",
                               "chips": 1})
    bench["per_layer"].append({"name": "emails_per_batch.trio", "unit": "emails",
                               "moves": "proofs_per_s", "workloads": ["toy2.trio"]})
    spec = H.cell_spec(bench, "toy2.trio", root=root)
    assert spec["config"]["setup_seed"] == 6 and spec["mix"]["batch"] == 3
    assert "emails_per_batch.trio" in [m["name"] for m in spec["per_layer"]]
    assert H.reader("emails_per_batch.trio", root)({"batches": [{"requests": 3}]}) == 3
    other = H.cell_spec(bench, "toy.pair", root=root)
    assert "emails_per_batch.trio" not in [m["name"] for m in other["per_layer"]]


def test_every_metric_of_the_benchmark_has_a_reader_and_every_cell_reports_enough():
    bench = json.loads((H.REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(H.reader(m["name"]))
    for w in bench["workloads"]:
        spec = H.cell_spec(bench, w["name"])
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
        assert (H.HERE / "circuits" / f"{spec['config']['circuit']}.py").is_file()
