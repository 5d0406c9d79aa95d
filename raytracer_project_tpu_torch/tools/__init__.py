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
the ms per launch (`time_ms`). Where the reference probe only compiled
(P2-P4), the twin also runs and times the kernel. Beside the probes,
`bench_turns` times two checkouts of the port in turns on one card, and
the twins of the repository's other tools: `make_goldens`,
`make_smoke_goldens` and `make_device_goldens` (the goldens' writers),
`train_denoiser`, `prof_fused_step`, `make_parity_gallery` and
`bench_bvh`.

`time_ms` is the port's one device timer: chip_smoke.py's kernel table,
the probes, bench_bvh's walk sweep and prof_fused_step read it.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import time

import torch

from .. import kernels

# About 0.1 s of device sleep ahead of each timed round (at ~2 GHz).
SLEEP_CYCLES = 200_000_000


def build(source: str, device: torch.device) -> None:
    """Build csrc/<source>.cu if it is stale (card only) and print the nvcc
    seconds."""
    if device.type != "cuda":
        return
    secs = kernels.build_all(names=(source,))
    print(f"nvcc {source}.cu: "
          + (f"{secs:.1f} s" if secs else "up to date, not rebuilt"), flush=True)


def time_ms(fn, device, n: int = 20, rounds: int = 5) -> float:
    """ms per call of `fn`: `n` calls back to back, divided by `n`; the
    median over `rounds`, after a warm-up call. On the card the calls run
    between CUDA events behind a device sleep, which lets the host queue
    all `n` before the first one starts, so the wrapper's host cost does
    not show in the time; a round whose queueing outlasted the sleep is
    host-bound, and `time_ms.host_bound` holds the count of such rounds of
    the last call. On the CPU the host clock."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    times, host_bound = [], 0
    for _ in range(rounds):
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / n)
            continue
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        host_bound += queued_ms > ev[0].elapsed_time(ev[1])
        times.append(ev[1].elapsed_time(ev[2]) / n)
    time_ms.host_bound = host_bound
    times.sort()
    return times[len(times) // 2]


time_ms.host_bound = 0


def launch_floor(n: int) -> None:
    """One launch of csrc/launch_floor.cu's empty kernel over n lanes
    (ceil(n / 128) blocks of 128 threads) on the current CUDA device: what
    `time_ms` reads for a launch with no work in it (card only)."""
    kernels.launch("launch_floor", n)


def sass_opcodes(source: str) -> dict:
    """Opcode counts of each kernel of the built csrc/<source>.cu, from
    cuobjdump -sass (mangled kernel name -> {opcode: count}; card only)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass",
                           str(kernels.BUILD_DIR / f"lib{source}.so")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts


def ptxas_resources(source: str) -> dict:
    """Registers, spill-store bytes and stack frame bytes of each kernel of
    csrc/<source>.cu from its build log (nvcc -Xptxas -v): mangled name ->
    (registers, spill bytes, stack bytes)."""
    out, cur = {}, None
    for line in (kernels.BUILD_DIR / f"{source}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and cur:
            out[cur][2], out[cur][1] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def kernel_code(source: str, tag: str) -> dict:
    """{mangled name: (SASS opcode counts, (registers, spill bytes, stack
    bytes))} of the kernels of csrc/<source>.cu whose name holds `tag`."""
    res = ptxas_resources(source)
    return {name: (ops, res.get(name, (None, None, None)))
            for name, ops in sass_opcodes(source).items() if tag in name}


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """A parser with the common `--device` option (cuda unless asked)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain versions)")
    return ap
