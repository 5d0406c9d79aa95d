"""pool.occupancy: live lanes per step over the pool's lanes, in % -- the
pool's exact segment count over (steps x pool lanes) in the traced updates."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("steps"):
        return None
    return 100.0 * c["segments"] / (c["steps"] * ctx["pool_lanes"])
