"""h_stage_s (program span): seconds per batch of prove_batch's h stage
(its own timers["h_stage_s"], after a device sync; mean over the window)."""

from proofbench.runstats import timer_mean


def read(run: dict):
    return timer_mean(run, ("h_stage_s",))
