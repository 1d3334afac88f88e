"""On the card: the tiny cell's whole traced run, through the real kernels,
is correct and its device-trace metrics are shares below 100%. Skips
without a card; on the card: python -m pytest proofbench/tests -q -m cuda"""

import time

import pytest

from proofbench import harness as H
from proofbench.tests.toycell import make_root


@pytest.mark.cuda
def test_traced_toy_run_on_the_card(cuda_device, tmp_path):
    bench, root = make_root(tmp_path)
    bench["per_layer"].append({"name": "k2_roofline.batch", "unit": "%",
                               "moves": "proofs_per_s"})
    spec = H.cell_spec(bench, "toy.pair", root=root)
    recs = H.run_cell(spec, 2**31 + 5, 1.0, True, "cuda", time.time())
    out = H.result(spec, recs, 2**31 + 5, True, 1)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    m = out["metrics"]
    assert 0 < m["device_idle.batch"]["value"] < 100
    assert 0 < m["k2_roofline.batch"]["value"] <= 100
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
