"""device.idle_share: 1 - busy / window over the traced frames, in %: busy
is the union of every kernel, copy and set on the card in the profiler's
trace, the window the traced host wall."""


def read(ctx):
    if not ctx["traces"] or ctx["traces"][0]["busy_s"] <= 0.0:
        return None
    t = ctx["traces"][0]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
