"""The control of a cell's check, on the card at the cell's own size:

    python3 -m benchmark.control --workload <name> --seeds 11,12,13

For each seed, the frames and pixels a run with that seed checks first
(harness.Plan) are rendered by the reference twice: as the configuration
states it (float32) and as the control, the same arithmetic with its path
state and hit distances rounded to bfloat16 after every step, standing in
for the program. Prints one JSON line per seed with the control's
`px_off_share`: the reading a program computing in the nearest precision
below float32 would give. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def readings(cell, seed: int, device) -> dict:
    import torch

    from . import compare
    from .harness import Plan
    from .reference.render import Reference

    plan = Plan(cell.cfg, cell.traffic, seed)
    ref = Reference(cell.generator, cell.cfg, device)
    want, got = [], []
    for f in range(plan.check_frames):
        args = (plan.camera(f), plan.width, plan.height, plan.key(f),
                plan.check_ids, plan.frame_spp)
        want.append((ref.sums(*args) / plan.frame_spp).cpu().numpy())
        got.append((ref.sums(*args, round_to=torch.bfloat16)
                    / plan.frame_spp).cpu().numpy())
    return compare.numbers(np.concatenate(got), np.concatenate(want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    from .harness import load_cell

    cell = load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": device, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
