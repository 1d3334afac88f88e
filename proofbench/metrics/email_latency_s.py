"""email_latency_s (host clock): the window, from its start to the end of
its last request, over the requests completed (a closed loop of one email
a request: the mean time a user waits for a proof)."""


def read(run: dict):
    done = sum(b["requests"] for b in run["batches"] if not b.get("failed"))
    return run["window_s"] / done if done else None
