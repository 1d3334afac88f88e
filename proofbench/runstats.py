"""Means over the window's batches of a run record, for the metric readers."""


def mean(values: list):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def span_mean(run: dict, name: str):
    """Seconds of one layer's span per batch (spans end with a device sync
    in a traced run)."""
    return mean([b.get("spans", {}).get(name) for b in run["batches"]])


def timer_mean(run: dict, names: tuple):
    """Seconds per batch of the sum of the prove's stage timers `names`."""
    return mean([sum(b["timers"][n] for n in names) if b.get("timers") else None
                 for b in run["batches"]])
