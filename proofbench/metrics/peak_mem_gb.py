"""peak_mem_gb (device counter, GB): torch.cuda.max_memory_allocated over
the window, after a reset at its start."""


def read(run: dict):
    peak = run.get("window_peak_bytes")
    return peak / 1e9 if peak else None
