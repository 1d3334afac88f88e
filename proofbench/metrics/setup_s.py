"""setup_s (host clock): from the process's start to the first timed batch."""


def read(run: dict):
    return run["setup_s"]
