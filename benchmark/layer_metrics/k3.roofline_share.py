"""k3.roofline_share: K3 fused's byte bound (benchmark/roofline: 140 B per
live lane, 12 B per finished path, the scene's tables once per launch)
over the device time of its two launches in the trace (`shade_kernel` and
`respawn_kernel`, csrc/shade_advance.cu), in %."""

from benchmark import roofline
from benchmark.trace import kernel_seconds


def read(ctx):
    c = ctx["counters"]
    if not ctx["traces"] or not c.get("segments"):
        return None
    dev_s = kernel_seconds(ctx["traces"][0], "shade_kernel<", "respawn_kernel<")
    if dev_s <= 0.0:
        return None
    paths = ctx["samples_per_update"] * len(ctx["updates"])
    nbytes = roofline.k3_bytes(c["segments"], paths, c["k3_launches"],
                               ctx["counts"], ctx["n_materials"],
                               ctx["n_volumes"])
    return 100.0 * roofline.bound_seconds(nbytes) / dev_s
