"""The traced run's device timeline: `torch.profiler` over a steady part of
the window, reduced to what the per-layer readers and the result line use.

A `Trace` opens the profiler (CPU and, on the card, CUDA activities) and
closes it; `summary` gives the device's busy seconds (the union of every
kernel, copy and set interval), the traced window's seconds, the device
seconds of each kernel name, the busy seconds of the work (the same union
without NCCL's kernels, which on a rank mostly wait for the others), the
ten costliest device operations and the
ten largest idle totals, each gap named by the innermost host event that
was running across its middle (a benchmark span, a runtime call or a torch
op). Times come from the profiler's own events (`kineto_results`).
"""

from __future__ import annotations

import collections
import heapq
import sys
import time

import torch

# A device gap shorter than this is launch spacing, not idle host time.
GAP_NS = 2_000


def warm(device: torch.device) -> None:
    """Start and stop the profiler once around a small operation: its first
    start on the card (CUPTI's set-up) takes seconds, which belong to
    set-up, not to the traced window."""
    t = Trace(device)
    t.start()
    torch.ones(1024, device=device).sum().item()
    t.stop()


class Trace:
    """Profile the block of code between `start` and `stop`."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.t0_ns = self.t1_ns = None

    def start(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def events(self):
        """(device events, host events): lists of (name, start_ns, end_ns).
        Device events are kernels, copies and sets; the device timeline's
        copies of the benchmark's spans (user annotations) are neither."""
        dev, host = [], []
        cpu = torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.name(), int(e.start_ns()), int(e.end_ns()))
            if hasattr(e, "activity_type"):
                kind = str(e.activity_type()).lower()
                on_device = "annotation" not in kind and (
                    kind == "kernel" or "memcpy" in kind or "memset" in kind)
            else:   # older kineto bindings: no activity type
                annotation = (e.is_user_annotation()
                              if hasattr(e, "is_user_annotation") else False)
                on_device = (e.device_type() != cpu and not annotation
                             and not rec[0].startswith("bench."))
            if on_device:
                dev.append(rec)
            elif e.device_type() == cpu:
                host.append(rec)
        return dev, host

    def summary(self) -> dict:
        dev, host = self.events()
        span = [min((r[1] for r in dev + host), default=0),
                max((r[2] for r in dev + host), default=0)]
        print(f"trace: {len(dev)} device and {len(host)} host events over "
              f"[{span[0]}, {span[1]}] ns, window [{self.t0_ns}, {self.t1_ns}]",
              file=sys.stderr)
        return summarize(dev, host, self.t0_ns, self.t1_ns)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, times):
    """For each of the increasing `times`, the name of the latest-started
    host event still running then (the innermost on a nested stack), or
    "no host event": one sweep with a heap of the events begun so far."""
    events = sorted(host, key=lambda r: r[1])
    heap, names, k = [], [], 0
    for t in times:
        while k < len(events) and events[k][1] <= t:
            heapq.heappush(heap, (-events[k][1], events[k][2], events[k][0]))
            k += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        names.append(heap[0][2] if heap else "no host event")
    return names


def summarize(dev, host, t0_ns: int, t1_ns: int) -> dict:
    """Busy and idle of the device over [t0_ns, t1_ns] (host clock).

    dev, host: lists of (name, start_ns, end_ns)."""
    clip = [(name, max(a, t0_ns), min(b, t1_ns)) for name, a, b in dev]
    busy = _union([(a, b) for _, a, b in clip if b > a])
    busy_ns = sum(b - a for a, b in busy)
    work = _union([(a, b) for name, a, b in clip
                   if b > a and "nccl" not in name.lower()])
    per_name = collections.Counter()
    for name, a, b in dev:
        per_name[name] += (b - a) * 1e-9
    gaps, prev = [], t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a - prev >= GAP_NS:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = collections.Counter()
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) // 2
                                                   for a, b in gaps])):
        idle[name] += (b - a) * 1e-9
    return {
        "busy_s": busy_ns * 1e-9,
        "work_busy_s": sum(b - a for a, b in work) * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "kernel_s": dict(per_name),
        "device_ops": [[n, s] for n, s in per_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
    }


def kernel_seconds(summary: dict, *patterns: str) -> float:
    """Device seconds of the kernels whose name holds any of `patterns`."""
    return sum(s for n, s in summary["kernel_s"].items()
               if any(p in n for p in patterns))
