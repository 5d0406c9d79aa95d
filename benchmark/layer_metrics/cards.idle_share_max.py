"""cards.idle_share_max: the highest share of the traced frames, in %, in
which a card of a multi-card frame does no work: each rank's profiler over
the same frames, busy counted without NCCL's kernels (a rank waiting in the
gather for the others is idle, not working)."""


def read(ctx):
    if ctx["ranks"] < 2:
        return None
    traces = [t for t in ctx["traces"] if t["work_busy_s"] > 0.0]
    if len(traces) < ctx["ranks"]:
        return None
    return 100.0 * max(1.0 - t["work_busy_s"] / t["window_s"] for t in traces)
