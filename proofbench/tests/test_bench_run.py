"""Whole runs of a tiny cell on the CPU: the harness past its look for a
chip, the program's path at B = 2, the reference's check. A sound run is
correct; the control and each fault a one-chip cell can have make it
incorrect; a mesh cell runs on gloo ranks; the command itself refuses to
run without a card."""

import json
import random
import time

import pytest
import torch

from proofbench import harness as H
from proofbench.control import readings, tampered
from proofbench.reference import bn254 as B
from proofbench.tests.toycell import make_root

SEED = 2**31 + 99
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A set-up rank of the toy cell, its sound window's result, and the
    real proofs of its warm-up and window batches."""
    bench, root = make_root(tmp_path_factory.mktemp("toy"))
    spec = H.cell_spec(bench, "toy.pair", root=root)
    real, prove = [], H._prove

    def recording(*args):
        out = prove(*args)
        real.append(out)
        return out

    H._prove = recording
    try:
        rank = H.Rank(spec, SEED, 0.5, False, "cpu", time.time())
        rank.setup()
        first = rank.next
        rank.window()
        result = H.result(spec, [rank.record(free=False)], SEED, False, 1)
        rank.run_batch()  # the batch after the window: a traced run's
    finally:
        H._prove = prove
    return {"spec": spec, "rank": rank, "first": first, "real": real, "result": result}


def rerun(toy, fake, trace=False):
    """The toy's window again, its emails and rng as before, `fake` in place
    of the prove entry; the run's result."""
    rank = toy["rank"]
    rank.next, rank.batches, rank.traced = toy["first"], [], None
    rank.seconds = 0  # one batch: the loop always finishes the batch it started
    rank.rng = random.Random(f"proofbench-prove:{SEED}")
    rank.trace = rank.spans.traced = trace
    prove = H._prove
    H._prove = fake
    try:
        rank.window()
        if trace:
            rank.traced_batch()
    finally:
        H._prove = prove
        rank.trace = rank.spans.traced = False
    return H.result(toy["spec"], [rank.record(free=False)], SEED, trace, 1)


def window_proofs(toy):
    return toy["real"][1]  # [0] is the warm-up batch's, [2] the one after the window


def test_sound_run_is_correct_and_reports_its_metrics(toy):
    out = toy["result"]
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"proofs_per_s", "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    assert list(out)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics(toy):
    batches = iter(toy["real"][1:])  # the window's, then the traced batch's
    out = rerun(toy, lambda *a: next(batches), trace=True)
    assert out["correct"] and out["attempted"] == 4
    assert {"inputs_s.batch", "witness_s.batch", "prove_s.batch"} <= set(out["metrics"])
    assert "device_idle.batch" not in out["metrics"]  # no device on the CPU
    assert out["device"]["window_s"] > 0 and set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_fault_state_returned_unchanged(toy):
    out = rerun(toy, lambda *a: toy["real"][0])  # the warm-up batch's proofs again
    assert not out["correct"] and out["checks"]["publics_wrong"]["value"] == 2


def test_fault_half_the_batch_left_out(toy):
    out = rerun(toy, lambda *a: window_proofs(toy)[:1] * 2)
    assert not out["correct"] and out["failed"] == 1


def test_fault_an_answer_altered_where_produced(toy):
    (p0, pub0), rest = window_proofs(toy)[0], window_proofs(toy)[1:]
    a = B.G1(int(p0.a.x), int(p0.a.y)).add(B.G1_GEN)
    bad = type(p0)(type(p0.a)(a.x, a.y), p0.b, p0.c)
    out = rerun(toy, lambda *args: [(bad, pub0)] + rest)
    assert not out["correct"] and out["checks"]["proofs_rejected"]["value"] == 1


def test_control_witness_off_the_circuit_is_rejected(toy):
    prove = H._prove
    H._prove = tampered(prove)
    try:
        got = readings(toy["rank"], SEED + 1)
    finally:
        H._prove = prove
    assert got["requests"] == 2 and got["proofs_rejected"] == 2
    assert got["publics_wrong"] == 0  # the publics were not touched


def test_mesh_cell_runs_on_gloo_ranks(tmp_path):
    bench, root = make_root(tmp_path, mesh=(2, 1))
    spec = H.cell_spec(bench, "toy.pair", root=root)
    recs = H.run_cell(spec, SEED, 0.5, False, "cpu", time.time())
    assert len(recs) == 2
    out = H.result(spec, recs, SEED, False, 1)
    assert out["correct"] and out["attempted"] == 2


def test_command_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert H.main(["--workload", "full1024.b8", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
    bench = json.loads((H.REPO / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "proofbench/run.py"]
