"""fog.scatter_share: the share of the pool's path segments that end in a
medium, in % -- 100 x scatters / segments of the port's process-wide totals
(`ops/fused_step.py` `render_pool_fused.scatters` and `.segments`, to which
each pool call adds the stats it reads; on the card K3 fused's fog variant
counts the scatters). None on a program without the totals, and before any
segment."""


def read(ctx):
    try:
        from raytracer_project_tpu_torch.ops import fused_step
    except ImportError:
        return None
    pool = fused_step.render_pool_fused
    segments = getattr(pool, "segments", None)
    scatters = getattr(pool, "scatters", None)
    if segments is None or scatters is None or segments <= 0:
        return None
    return 100.0 * scatters / segments
