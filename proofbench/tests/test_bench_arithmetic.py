"""The yardstick's arithmetic: the h stage's least work from shapes, the
choice of bound, the device trace's busy and idle seconds and the shares
the readers make of them."""

import pytest

from proofbench import harness as H
from proofbench import roofline, tracing

PEAKS = {"int32_per_s": 1e12, "bytes_per_s": 1e9}


def butterflies(log_m: int) -> int:
    """Butterflies of a textbook iterative radix-2 NTT, counted by running
    its loops."""
    m, n, half = 1 << log_m, 0, 1
    while half < m:
        for start in range(0, m, 2 * half):
            n += half
        half *= 2
    return n


def test_h_stage_work_on_a_small_domain():
    shapes = {"log_m": 3, "n_signals": 5, "nnz_A": 10, "nnz_B": 6, "rows_A": 4, "rows_B": 3}
    ops, nbytes = roofline.h_stage_work(shapes, batch=2)
    mul, add = roofline.OPS_MUL, roofline.OPS_ADD
    assert (mul, add) == (280, 24)
    per_proof = (16 * mul + 9 * add + 8 * mul + 6 * butterflies(3) * (mul + 2 * add)
                 + 3 * 8 * mul + 8 * (mul + add))
    assert ops == 2 * per_proof == 2 * 39704
    assert nbytes == 16 * 40 + 2 * (5 + 8) * 32


def test_least_time_names_the_larger_bound():
    assert roofline.least_time(2e12, 1e9, PEAKS) == (2.0, "operations")
    assert roofline.least_time(1e12, 3e9, PEAKS) == (3.0, "bytes")
    assert roofline.K2_OPS == 12 * 280 + 27 * 24 and roofline.K2_BYTES == 9 * 22 * 4 + 4


EVENTS = [
    ("user_annotation", "pb.batch", 0.0, 100.0),
    ("user_annotation", "pb.inputs", 0.0, 20.0),
    ("user_annotation", "pb.witness", 20.0, 40.0),
    ("user_annotation", "pb.prove", 60.0, 40.0),
    ("kernel", "mont_mul_kernel", 25.0, 10.0),
    ("kernel", "ec_add_g1_kernel", 30.0, 10.0),  # overlaps the one before
    ("gpu_memcpy", "Memcpy HtoD", 70.0, 10.0),
    ("cpu_op", "aten::add", 1.0, 99.0),  # host work is not device time
]


def test_trace_reduction_busy_idle_and_names():
    tr = tracing.reduce_trace(EVENTS, {"h_stage_s": 15e-6, "msm_h_s": 10e-6})
    assert tr["window_s"] == pytest.approx(100e-6)
    assert tr["busy_s"] == pytest.approx(25e-6)
    assert tr["k2_s"] == pytest.approx(10e-6)
    assert tr["device_ops"]["mont_mul_kernel"] == pytest.approx(10e-6)
    # idle: [0, 25) in the inputs, [40, 70) in the witness, and [80, 100),
    # whose midpoint 90 is past the h stage (60-75) and msm_h (75-85): the blind
    assert tr["idle"] == pytest.approx({"inputs": 25e-6, "witness": 30e-6, "prove.blind": 20e-6})
    assert sum(tr["idle"].values()) + tr["busy_s"] == pytest.approx(tr["window_s"])
    run = {"traced": {"trace": dict(tr, k2_lanes=1000)}, "peaks": PEAKS}
    assert H.reader("device_idle.batch")(run) == pytest.approx(75.0)
    least = max(1000 * roofline.K2_OPS / 1e12, 1000 * roofline.K2_BYTES / 1e9)
    assert H.reader("k2_roofline.batch")(run) == pytest.approx(100 * least / 10e-6)


def test_readers_leave_out_what_they_cannot_read():
    run = {"traced": None, "batches": [{"requests": 2, "timers": None}], "peaks": None,
           "window_peak_bytes": None}
    for name in ("device_idle.batch", "k2_roofline.batch", "h_stage_roofline.batch",
                 "h_stage_s.batch", "plan_hit_share.batch", "peak_mem_gb.single"):
        assert H.reader(name)(run) is None


def test_h_stage_roofline_and_plan_share_from_timers():
    shapes = {"log_m": 3, "n_signals": 5, "nnz_A": 10, "nnz_B": 6, "rows_A": 4, "rows_B": 3}
    plan = {"a": "hit", "b2": "hit", "b1": "miss", "c": "hit"}
    run = {"shapes": shapes, "peaks": PEAKS,
           "batches": [{"requests": 2, "timers": {"h_stage_s": 1e-6, "plan": plan}},
                       {"requests": 2, "timers": {"h_stage_s": 3e-6, "plan": plan}}]}
    least = roofline.least_time(*roofline.h_stage_work(shapes, 2), PEAKS)[0]
    assert H.reader("h_stage_roofline.batch")(run) == pytest.approx(100 * 2 * least / 4e-6)
    assert H.reader("plan_hit_share.batch")(run) == 75.0
