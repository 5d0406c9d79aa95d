"""Make the device goldens the smoke gate holds the card's renders against
(twin of the repository's tools/make_device_goldens.py).

Run from the repository root on a machine with the card:

    python -m raytracer_project_tpu_torch.tools.make_device_goldens [--out DIR]

Renders each smoke image (utils/smoke.py render_fused_fast,
render_fused_features, render_pool) RUNS (3) times on the card and writes
DIR/<name>_cuda.npz (default: the port's goldens/ directory) with the
image (`beauty`), the card's name (`device`) and the CUDA version
(`cuda`). The gate compares later card renders against them at mean |d|
<= 1e-5. Regenerate them only with a change meant to alter pixels, and
say so in CHANGES.md.

Interlocks: an image is written only when its runs agree to mean |d| <=
1e-6 between any two (a golden must hold ten times tighter than its
budget), and when it passes its CPU golden (tests/goldens/<name>.npz)
under the cross-backend budgets, so a systematically wrong card path is
never enshrined as the reference. Any refused image makes the exit code
1; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch

from ..utils import smoke
from . import goldens

# Renders of each image, and the largest mean |d| between two of them that
# a golden may have.
RUNS = 3
SPREAD_MEAN = smoke._DEVICE_MEAN / 10


def spread(runs) -> tuple[float, float]:
    """(largest mean |d|, largest max |d|) between any two of the arrays
    `runs` (0, 0 for one run)."""
    pairs = [np.abs(a - b) for a, b in itertools.combinations(runs, 2)]
    if not pairs:
        return 0.0, 0.0
    return max(float(d.mean()) for d in pairs), max(float(d.max()) for d in pairs)


def write_goldens(renders, out, info: smoke.DeviceInfo) -> int:
    """renders: one list of stage images [(name, label, max_frac, img)]
    per run, in the same order. Writes out/<name>_cuda.npz for each image
    that passes both interlocks; 1 if any was refused, else 0."""
    out = goldens.writable_dir(out)
    rc = 0
    for k, (name, _label, _max_frac, img) in enumerate(renders[0]):
        mean_run, max_run = spread([r[k][3] for r in renders])
        print(f"{name}: {len(renders)} runs, largest mean|d| between runs "
              f"{mean_run:.3e}, max|d| {max_run:.3e}", flush=True)
        if mean_run > SPREAD_MEAN:
            print(f"{name}: REFUSING device golden — its runs differ by mean "
                  f"|d| {mean_run:.3e} > {SPREAD_MEAN:.0e}", file=sys.stderr)
            rc = 1
            continue
        cpu_path = smoke._golden_path(name)
        if not cpu_path.exists():
            print(f"{name}: no CPU golden to cross-check ({cpu_path})",
                  file=sys.stderr)
            rc = 1
            continue
        mean_d, frac = smoke._diff(img, np.load(cpu_path)["beauty"])
        print(f"{name}: vs CPU golden mean|d|={mean_d:.5f} "
              f"frac(>0.05)={frac:.4f}", flush=True)
        if mean_d > smoke._XBACKEND_MEAN or frac > smoke._XBACKEND_FRAC:
            print(f"{name}: REFUSING device golden — the card's render "
                  f"systematically disagrees with the CPU golden (budgets "
                  f"{smoke._XBACKEND_MEAN}/{smoke._XBACKEND_FRAC})",
                  file=sys.stderr)
            rc = 1
            continue
        goldens.write_golden(out, name + smoke.DEVICE_SUFFIX, img,
                             device=np.str_(info.name), cuda=np.str_(info.cuda))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(smoke.DEVICE_GOLDEN_DIR),
                    help="directory for the *_cuda.npz files")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("make_device_goldens: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    info = smoke.device_info(dev)
    print(f"device {info.name}, CUDA {info.cuda}, torch {torch.__version__}",
          flush=True)
    renders = [smoke.render_fused_fast(dev) + smoke.render_fused_features(dev)
               + smoke.render_pool(dev) for _ in range(RUNS)]
    return write_goldens(renders, args.out, info)


if __name__ == "__main__":
    sys.exit(main())
