"""P2: the one-hot row-fetch probe (twin of the reference's
tools/probe_onehot.py, whose Pallas kernel this ports as
csrc/probe_onehot.cu), and the fetch that P4 (probe_onehot2.py) shares.

For every lane i and k < n_out:

    out_k[i] = table[int(idx[i]), k % 28] + t[i]

idx is f32 truncated to i32; a row outside [0, n_rows) gives 0 (the
reference's one-hot row matches no table row). The fetch is exact, as the
reference's is on the CPU (on the TPU its default-precision one-hot dot
rounds the table to bf16; the port follows the CPU). The reference sweeps
the table in `window`-row one-hot matmuls, D lanes per grid step; on the
card a fetch is one indexed load and the launch covers every lane, so
D_BLOCK and WINDOW are accepted and change nothing.

    python -m raytracer_project_tpu_torch.tools.probe_onehot \\
        D_BLOCK WINDOW N_ROWS N_OUT [P] [--device cpu]
    e.g. ... probe_onehot 2048 512 1536 24

The reference probe compiled its kernel on ones and zeros; this one runs
the fetch on a random table and random indices in [-2, n_rows + 2) made
from a seed, and prints the ms per launch.

On the card `onehot_fetch` launches csrc/probe_onehot.cu's fetch_kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import arg_parser, build, time_ms

COLS = 28
MAX_OUT = 32
# mode -> (plain, transposed table, one [n_out, p] matrix out)
MODES = {"plain": (1, 0, 0), "col": (0, 0, 0), "colmat": (0, 0, 1),
         "tdot": (0, 1, 1), "tdotflat": (0, 1, 0)}


def _check(table, n_out: int, mode: str) -> int:
    """The table's row count, after checking its layout for `mode`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 0 <= n_out <= MAX_OUT:
        raise ValueError(f"n_out {n_out} outside [0, {MAX_OUT}]")
    transposed = MODES[mode][1]
    if table.dim() != 2 or table.shape[0 if transposed else 1] != COLS:
        raise ValueError(f"mode {mode} takes a table of "
                         f"{'[28, n_rows]' if transposed else '[n_rows, 28]'}"
                         f", got {tuple(table.shape)}")
    return table.shape[1 if transposed else 0]


def onehot_fetch_plain(t, idx, table, n_out: int, mode: str):
    """Plain PyTorch fetch. t, idx f32[p]; table f32[n_rows, 28] (or
    [28, n_rows] in the transposed modes tdot, tdotflat). Returns one
    f32[n_out, p] in the matrix modes (colmat, tdot), else a tuple of n_out
    f32[p]."""
    n_rows = _check(table, n_out, mode)
    plain, transposed, matrix = MODES[mode]
    if plain:
        outs = [t + float(k) for k in range(n_out)]
    else:
        row = idx.to(torch.int32).long()
        inside = (row >= 0) & (row < n_rows)
        rows = (table.T if transposed else table)[row.clamp(0, n_rows - 1)]
        rows = torch.where(inside[:, None], rows, 0.0)
        outs = [rows[:, k % COLS] + t for k in range(n_out)]
    if matrix:
        return torch.stack(outs) if outs else t.new_empty((0, t.shape[0]))
    return tuple(outs)


def onehot_fetch(t, idx, table, n_out: int, mode: str,
                 staged: bool | None = None):
    """The fetch of `onehot_fetch_plain`: CPU tensors take it, CUDA tensors
    launch csrc/probe_onehot.cu's fetch_kernel, which reads the table in
    16 B pieces and so takes it 16 B aligned. `staged` True copies the
    table into each block's shared memory before the gathers (the modes
    with a table; at most 2,075 rows), False gathers in place (both for
    the tests and the measurements), None lets the kernel's entry choose by
    the gathers of the launch."""
    if staged and mode == "plain":
        raise ValueError("mode plain fetches no table to stage")
    if t.device.type == "cpu":
        return onehot_fetch_plain(t, idx, table, n_out, mode)
    n_rows = _check(table, n_out, mode)
    if table.data_ptr() % 16:
        raise ValueError("the fetch kernel takes a 16 B aligned table")
    kernels.require_cuda(t, idx, table, dtype=torch.float32)
    plain, transposed, matrix = MODES[mode]
    p = t.shape[0]
    if matrix:
        out = torch.empty((n_out, p), dtype=torch.float32, device=t.device)
        ptrs, res = None, out
    else:
        res = tuple(torch.empty((p,), dtype=torch.float32, device=t.device)
                    for _ in range(n_out))
        ptrs = (ctypes.c_void_p * max(n_out, 1))(*[o.data_ptr() for o in res])
        out = None
    kernels.launch("probe_onehot", plain, transposed, matrix,
                   -1 if staged is None else int(staged), t, idx, table,
                   n_rows, n_out,
                   None if ptrs is None else ctypes.addressof(ptrs), out, p)
    kernels.count(onehot_fetch)
    return res


onehot_fetch.launches = 0


def make_inputs(n_rows: int, p: int, transposed: bool = False, seed: int = 0,
                device="cuda"):
    """(t, idx, table): t and the table N(0, 1), idx uniform in
    [-2, n_rows + 2), so that some rows fall outside the table."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn((p,), generator=g)
    idx = torch.rand((p,), generator=g) * (n_rows + 4) - 2.0
    table = torch.randn((n_rows, COLS), generator=g)
    if transposed:
        table = table.T
    return tuple(x.contiguous().to(device) for x in (t, idx, table))


def run(mode: str, n_out: int, n_rows: int, p: int, device, label: str,
        n: int = 20) -> dict:
    """Time the fetch in `mode` on random inputs; prints one line."""
    t, idx, table = make_inputs(n_rows, p, MODES[mode][1], device=device)
    ms = time_ms(lambda: onehot_fetch(t, idx, table, n_out, mode), device, n)
    print(f"OK {label} n_rows={n_rows} n_out={n_out} p={p} {ms:.5f} ms/launch",
          flush=True)
    return {"ms": ms}


def main(D: int, window: int, n_rows: int, n_out: int, p: int = 8192,
         device="cuda") -> dict:
    dev = torch.device(device)
    build("probe_onehot", dev)
    return run("col", n_out, n_rows, p, dev, f"D={D} window={window}")


if __name__ == "__main__":
    ap = arg_parser(__doc__)
    for name in ("D_BLOCK", "WINDOW", "N_ROWS", "N_OUT"):
        ap.add_argument(name, type=int)
    ap.add_argument("P", type=int, nargs="?", default=8192)
    a = ap.parse_args()
    main(a.D_BLOCK, a.WINDOW, a.N_ROWS, a.N_OUT, a.P, a.device)
