"""Run one benchmark cell once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers compared for `correct`
beside their limits as the last lines of standard error, and one JSON
object as the last line of standard output. Exits non-zero, printing no
result, where the cell's cards are missing, where the port cannot be
imported, or where JAX or the JAX package was loaded in this process or
in any rank's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import compare, harness  # noqa: E402

# Build and kernel caches of the program stay inside the checkout, at fixed
# paths, so only a checkout's first run builds.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(harness.REPO / "build" / "bench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = harness.load_cell(args.workload)
    except (OSError, KeyError) as e:
        print(f"benchmark: cannot load workload {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    import torch

    # One host thread: the pool's host work is one Python thread, and idle
    # intra-op threads only contend for the cores the host shares.
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    try:
        import raytracer_project_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port cannot be imported: {e}", file=sys.stderr)
        return 2

    result, verdict = harness.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), T_START)
    return finish(result, verdict)


def finish(result: dict, verdict: dict) -> int:
    """Print the checks and the result line; or, where this process or any
    rank's process holds a forbidden module, name it and print no result."""
    bad = sorted(set(harness.forbidden_modules()) | set(verdict["forbidden"]))
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in compare.lines(verdict["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
