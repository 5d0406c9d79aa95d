"""hit.roofline_share: the closest hit's byte bound (benchmark/roofline: 36 B
per live lane, the geometry once per launch) over the device time of the
closest-hit kernel the pool ran, in %: K1's tile scan
(`tile_scan_kernel<true>`, csrc/closest_hit.cu) or the walk of the BVH
(`bvh_hit_kernel`, csrc/bvh_hit.cu). Both answer the same queries, so a
program on either is read against the same work."""

from benchmark import roofline
from benchmark.trace import kernel_seconds


def read(ctx):
    c = ctx["counters"]
    if not ctx["traces"] or not c.get("segments"):
        return None
    dev_s = kernel_seconds(ctx["traces"][0], "tile_scan_kernel<true",
                           "bvh_hit_kernel")
    if dev_s <= 0.0:
        return None
    nbytes = roofline.k1_bytes(c["segments"], c["k1_launches"], ctx["counts"])
    return 100.0 * roofline.bound_seconds(nbytes) / dev_s
