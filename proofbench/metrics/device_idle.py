"""device_idle (device trace, %): 1 - the device's busy seconds (the union
of its kernels, copies and sets) over the wall time of the profiled batch,
as prove_profile.py's device_summary computes the busy share."""


def read(run: dict):
    tr = (run.get("traced") or {}).get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
