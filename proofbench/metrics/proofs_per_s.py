"""proofs_per_s (host clock): proofs completed in the window over the
window, from its start to the end of its last batch."""


def read(run: dict):
    return sum(b["requests"] for b in run["batches"] if not b.get("failed")) / run["window_s"]
