"""P4: the one-hot row fetch in five layouts (twin of the reference's
tools/probe_onehot2.py, whose Pallas kernels this ports as
csrc/probe_onehot.cu, shared with P2; see probe_onehot.py for the fetch).

modes:
  plain    n_out flat outputs, values = t + k (no fetch)
  col      n_out flat outputs from table[idx, k]  (P2's layout)
  colmat   ONE [n_out, p] output, rows from table[idx, k]
  tdot     ONE [n_out, p] output, from the transposed table [28, n_rows]
  tdotflat n_out flat outputs, from the transposed table

    python -m raytracer_project_tpu_torch.tools.probe_onehot2 \\
        MODE N_OUT [D] [N_ROWS] [--device cpu]

D (the reference's lanes per grid step) is accepted and changes nothing
on the card. Runs the fetch on random inputs made from a seed and prints
the ms per launch.
"""

from __future__ import annotations

import torch

from . import arg_parser, build
from .probe_onehot import MODES, run


def main(mode: str, n_out: int, D: int = 2048, n_rows: int = 1536,
         p: int = 8192, device="cuda") -> dict:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
    dev = torch.device(device)
    build("probe_onehot", dev)
    return run(mode, n_out, n_rows, p, dev, f"mode={mode} D={D}")


if __name__ == "__main__":
    ap = arg_parser(__doc__)
    ap.add_argument("MODE", choices=tuple(MODES))
    ap.add_argument("N_OUT", type=int)
    ap.add_argument("D", type=int, nargs="?", default=2048)
    ap.add_argument("N_ROWS", type=int, nargs="?", default=1536)
    a = ap.parse_args()
    main(a.MODE, a.N_OUT, a.D, a.N_ROWS, device=a.device)
