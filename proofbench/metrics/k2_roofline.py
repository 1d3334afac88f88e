"""k2_roofline (device trace, %): K2 (ec_add_g1) in the profiled batch: the
least time of its lanes (counted at its launches; per lane the operations
and bytes of chip_smoke.py's KERNELS) over its device time by kernel name."""

from proofbench import roofline


def read(run: dict):
    tr = (run.get("traced") or {}).get("trace")
    peaks = run.get("peaks")
    if not tr or not peaks or not tr["k2_lanes"] or tr["k2_s"] <= 0:
        return None
    lanes = tr["k2_lanes"]
    least, _ = roofline.least_time(lanes * roofline.K2_OPS, lanes * roofline.K2_BYTES, peaks)
    return 100.0 * least / tr["k2_s"]
