"""Named spans of the port's host work: where the time of a session's step,
of the fused pool and of a multi-card frame goes.

    with spans.span("pool.setup"):
        ...

While a torch.profiler session runs, a span is a host event of the
profiler's trace, on the clock of the trace's kernels and copies, so a gap
of the device can be put down to the program span that was running across
it (the operator's `cli.py render --profile` trace, a benchmark's traced
run). Otherwise `span` returns one shared object that does nothing, after
one read of the profiler's flag; it reads no clock.

The profiler records the host events of the thread that started it; a
window thread's spans (parallel/render.run_windows) reach the trace only
when the profiler records every thread (`_ExperimentalConfig(
profile_all_threads=True)`, as `cli.py render --profile` opens it).
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

# The span while no profiler runs: one object for every call.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking a block as the span `name` (`layer.what`):
    the profiler's host event of that name (the C++ one, about a
    microsecond; record_function goes through the dispatcher and costs ten
    times that)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
