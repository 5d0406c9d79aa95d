"""Twins of the reference's kernel probes (tools/probe_*.py of the JAX
package), each a module with functions the tests and chip_smoke.py call:

  probe_a1_ablate  P1, K1's closest hit under four ablations
  probe_onehot     P2, the windowed one-hot row fetch (and the fetch kernel
                   that P4 shares, csrc/probe_onehot.cu)
  probe_onehot2    P4, the row fetch in five output/table layouts
  probe_decode     P3, K2's decode cut into prefixes d0-d2, and d3 = K2

Each keeps its reference's command line, run as

    python -m raytracer_project_tpu_torch.tools.<name> ARGS [--device cpu]

on the card by default (CUDA kernels), on the CPU with `--device cpu`
(the plain PyTorch versions). It prints the nvcc seconds of its source and
the ms per launch, from CUDA events on the card (host clock on the CPU).
Where the reference probe only compiled (P2-P4), the twin also runs and
times the kernel. Beside the probes, `bench_turns` times two checkouts of
the port in turns on one card, and the twins of the repository's other
tools: `make_goldens`, `make_smoke_goldens` and `make_device_goldens`
(the goldens' writers), `train_denoiser`, `prof_fused_step`,
`make_parity_gallery` and `bench_bvh`.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import kernels


def build(source: str, device: torch.device) -> None:
    """Build csrc/<source>.cu if it is stale (card only) and print the nvcc
    seconds."""
    if device.type != "cuda":
        return
    secs = kernels.build_all(names=(source,))
    print(f"nvcc {source}.cu: "
          + (f"{secs:.1f} s" if secs else "up to date, not rebuilt"), flush=True)


def time_ms(fn, device: torch.device, n: int = 10) -> float:
    """ms per call of `fn` over `n` calls after one warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def launch_floor(n: int) -> None:
    """One launch of csrc/launch_floor.cu's empty kernel over n lanes
    (ceil(n / 128) blocks of 128 threads) on the current CUDA device: what
    the probes' timer reads for a launch with no work in it (card only)."""
    kernels.launch("launch_floor", n)


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """A parser with the common `--device` option (cuda unless asked)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain versions)")
    return ap
