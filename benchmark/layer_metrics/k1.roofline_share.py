"""k1.roofline_share: K1's byte bound (benchmark/roofline: 36 B per live
lane, the geometry once per launch) over K1's device time in the trace,
in %. K1 is `tile_scan_kernel<true>` (csrc/closest_hit.cu)."""

from benchmark import roofline
from benchmark.trace import kernel_seconds


def read(ctx):
    c = ctx["counters"]
    if not ctx["traces"] or not c.get("segments"):
        return None
    dev_s = kernel_seconds(ctx["traces"][0], "tile_scan_kernel<true")
    if dev_s <= 0.0:
        return None
    nbytes = roofline.k1_bytes(c["segments"], c["k1_launches"], ctx["counts"])
    return 100.0 * roofline.bound_seconds(nbytes) / dev_s
