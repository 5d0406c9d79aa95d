"""Terminal rendering of the image-statistics histogram + legends (twin of
raytracer_project_tpu/utils/histview.py; the port keeps its own copy).

The reference engine displays the log-luminance histogram with
average/target markers and the luminance / BVH false-color legends in its
ImGui panel (main.cpp:1087-1165); the CLI/library equivalent renders the
same data (ops.post.ImageStatistics, tensors on any device, moved to numpy
here) as text.
"""

from __future__ import annotations

import numpy as np
import torch

# Histogram bin range matches ops.post.analyze_framebuffer: 256 bins of
# log2 luminance over 2^-10 .. 2^10 (color_processing.hpp:150-182).
_LOG_MIN, _LOG_MAX = -10.0, 10.0

_BLOCKS = " ▁▂▃▄▅▆▇█"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ascii_histogram(stats, *, width: int = 64, target_luminance: float | None
                    = None) -> str:
    """One-line-per-row text plot of the luminance histogram.

    stats: ops.post.ImageStatistics (histogram [256], avg_luminance).
    Markers: 'A' = average log-luminance, 'T' = auto-exposure target
    (main.cpp:1130-1165 parity).
    """
    hist = _host(stats.histogram).astype(np.float64)
    avg = float(_host(stats.average_luminance))
    nb = hist.shape[0]
    # Rebin to the terminal width.
    edges = np.linspace(0, nb, width + 1).astype(int)
    cols = np.asarray([hist[a:b].sum() for a, b in zip(edges[:-1], edges[1:])])
    peak = max(cols.max(), 1.0)
    levels = np.clip((cols / peak) * (len(_BLOCKS) - 1), 0,
                     len(_BLOCKS) - 1).astype(int)
    bar = "".join(_BLOCKS[l] for l in levels)

    def col_of(lum):
        x = (np.log2(max(float(lum), 1e-9)) - _LOG_MIN) / (_LOG_MAX - _LOG_MIN)
        return int(np.clip(x * width, 0, width - 1))

    marks = [" "] * width
    if target_luminance is not None:
        marks[col_of(target_luminance)] = "T"
    marks[col_of(avg)] = "A"
    lo, hi = 2.0 ** _LOG_MIN, 2.0 ** _LOG_MAX
    return (
        f"luma histogram  [{lo:g} .. {hi:g}] log2, peak {int(peak)} px\n"
        f"|{bar}|\n"
        f"|{''.join(marks)}|  A=avg {avg:.4f}"
        + (f"  T=target {target_luminance:.4f}"
           if target_luminance is not None else "")
    )


def luminance_legend() -> str:
    """Text twin of the luminance false-color legend (main.cpp:1087-1107)."""
    return ("luminance view: blue <0.25  green 0.25-0.5  yellow 0.5-0.75  "
            "red >0.75")


def bvh_legend(max_depth: int = 7) -> str:
    """Text twin of the BVH wireframe depth legend (main.cpp:1109-1128):
    neon depth colors g = depth * 0.15 (bvh.hpp:79-84)."""
    rows = [f"  depth {d}: rgb(1.0, {min(d * 0.15, 1.0):.2f}, 0.2)"
            for d in range(max_depth)]
    return "BVH wireframe legend (level -1 = leaves only):\n" + "\n".join(rows)
