"""msm_s (program span): seconds per batch of prove_batch's five MSMs, the
sum of its timers msm_{h,a,b2,b1,c}_s (mean over the window)."""

from proofbench.runstats import timer_mean


def read(run: dict):
    return timer_mean(run, ("msm_h_s", "msm_a_s", "msm_b2_s", "msm_b1_s", "msm_c_s"))
