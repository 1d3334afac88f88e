"""witness_s (program span): seconds per batch in the witness layer, the harness's
span around its call, ended with a device sync (mean over the window)."""

from proofbench.runstats import span_mean


def read(run: dict):
    return span_mean(run, "witness")
