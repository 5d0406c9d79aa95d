"""k3.fog_roofline_share: K3 fused's byte bound (benchmark/roofline's
`k3_bytes`: 140 B per live lane, 12 B per finished path, the scene's tables
and 64 B per fog volume once per launch) over the device time of its fog
variant and the respawn in the trace, in %.

The fog variant is `shade_kernel<SPEC, AOVS, true, true>` of
csrc/shade_advance.cu; in a beauty render the profiler names it
`void shade_kernel<false, false, true, true>(float const*, float const*,
int const*, int, ...)`, and the respawn `void respawn_kernel<false>(...)`.
None where no fog variant ran."""

from benchmark import roofline
from benchmark.trace import kernel_seconds

FOG_VARIANTS = tuple(f"shade_kernel<{spec}, {aovs}, true, true>"
                     for spec in ("false", "true")
                     for aovs in ("false", "true"))


def read(ctx):
    c = ctx["counters"]
    if not ctx["traces"] or not c.get("segments"):
        return None
    trace = ctx["traces"][0]
    fog_s = kernel_seconds(trace, *FOG_VARIANTS)
    if fog_s <= 0.0:
        return None
    dev_s = fog_s + kernel_seconds(trace, "respawn_kernel<")
    paths = ctx["samples_per_update"] * len(ctx["updates"])
    nbytes = roofline.k3_bytes(c["segments"], paths, c["k3_launches"],
                               ctx["counts"], ctx["n_materials"],
                               ctx["n_volumes"])
    return 100.0 * roofline.bound_seconds(nbytes) / dev_s
