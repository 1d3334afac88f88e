"""plan_hit_share (program counter, %): signal MSMs that found the key's
signal plan valid (timers["plan"] "hit") over all signal MSMs of the
window. A miss proves that MSM dense and rebuilds the plan."""


def read(run: dict):
    outcomes = [o for b in run["batches"] if b.get("timers")
                for o in b["timers"]["plan"].values()]
    return 100.0 * outcomes.count("hit") / len(outcomes) if outcomes else None
