"""Structured engine log + live metrics (twin of
raytracer_project_tpu/utils/applog.py; the port keeps its own copy).

The reference engine's AppLog (main.cpp:51-177):
timestamped ring log with tag-based severity ([Error]/[Config]/[Render]/
[System]/[Debug]) and two rays/s throughput metrics: rays_per_second()
reproduces the reference's W·H·spp·max_depth/Δt upper-bound *estimator*
(main.cpp:96-113); measured_rays_per_second() turns
the pools' actual traced-segment counter (ops/wavefront.py
stats) into a true throughput number.
"""

from __future__ import annotations

import collections
import time

RING_CAPACITY = 500       # main.cpp:58 (500-entry ring)

SEVERITY_TAGS = ("[Error]", "[Config]", "[Render]", "[System]", "[Debug]")


class AppLog:
    """Timestamped ring log with printf-style formatting."""

    def __init__(self, capacity: int = RING_CAPACITY, echo: bool = False):
        self.entries: collections.deque[str] = collections.deque(maxlen=capacity)
        self.echo = echo

    def add_log(self, fmt: str, *args) -> str:
        msg = fmt % args if args else fmt
        stamp = time.strftime("[%H:%M:%S]")
        line = f"{stamp} {msg}"
        self.entries.append(line)
        if self.echo:
            print(line, flush=True)
        return line

    def error(self, fmt, *args):
        return self.add_log("[Error] " + fmt, *args)

    def config(self, fmt, *args):
        return self.add_log("[Config] " + fmt, *args)

    def render(self, fmt, *args):
        return self.add_log("[Render] " + fmt, *args)

    def system(self, fmt, *args):
        return self.add_log("[System] " + fmt, *args)

    def debug(self, fmt, *args):
        return self.add_log("[Debug] " + fmt, *args)

    @staticmethod
    def severity_of(line: str) -> str:
        for tag in SEVERITY_TAGS:
            if tag in line:
                return tag.strip("[]")
        return "Info"


def rays_per_second(width: int, height: int, samples: int, max_depth: int,
                    elapsed_s: float) -> float:
    """The reference's throughput estimator (main.cpp:101-113):
    W*H*samples*max_depth / dt — an upper bound on traced rays (paths
    terminate well before max_depth on average)."""
    if elapsed_s <= 0:
        return 0.0
    return width * height * samples * max_depth / elapsed_s


def measured_rays_per_second(segments: float, elapsed_s: float) -> float:
    """True throughput from the traced-segment counter of
    integrator.accumulate_samples(with_stats=True): traced rays / dt."""
    if elapsed_s <= 0:
        return 0.0
    return float(segments) / elapsed_s
