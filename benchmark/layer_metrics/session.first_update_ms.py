"""session.first_update_ms: the median, over the traced frames, of each
frame's first update (a new RenderSession for the new camera, its first
chunk and the read-back), from the benchmark's spans around those calls."""

import statistics


def read(ctx):
    firsts = [1e3 * (t1 - t0) for f, i, t0, t1, _ in ctx["updates"]
              if i == 0 and f in ctx["frames"]]
    return statistics.median(firsts) if firsts else None
