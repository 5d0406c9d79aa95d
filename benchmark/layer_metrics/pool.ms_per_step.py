"""pool.ms_per_step: the traced updates' wall time over the fused pool's
exact step count in them (the stats accumulate_samples hands the session)."""


def read(ctx):
    steps = ctx["counters"].get("steps", 0)
    if not steps:
        return None
    wall = sum(t1 - t0 for _, _, t0, t1, _ in ctx["updates"])
    return 1e3 * wall / steps
