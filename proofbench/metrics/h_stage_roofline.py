"""h_stage_roofline (program span, %): the h stage's least time over its
measured time, summed over the window's batches. The least work is counted
from the shapes (roofline.h_stage_work) and priced at the card's peaks."""

from proofbench import roofline


def read(run: dict):
    peaks = run.get("peaks")
    timed = [b for b in run["batches"] if b.get("timers")]
    if not peaks or not timed:
        return None
    least = sum(roofline.least_time(*roofline.h_stage_work(run["shapes"], b["requests"]),
                                    peaks)[0] for b in timed)
    return 100.0 * least / sum(b["timers"]["h_stage_s"] for b in timed)
