"""The comparison that decides `correct`: the program's averaged beauty at
the checked pixels of the checked frames against the reference's.

A pixel is off when any channel differs from the reference's by more than
TOL * (1 + |reference|). The program and the reference trace the same
paths (a path depends only on the render key, the pixel and the sample),
so a pixel is off only where a path turned: a closest hit that the card's
arithmetic and the reference's decide differently (a grazing ray, a tie).
Those are rare; a fault in the timed path, or the same arithmetic in a
lower precision, puts most pixels off. `px_off_share` is compared with the
cell's limit (limits/<workload>.json, set from measured readings: PERF.md);
any non-finite value in the program's pixels fails the run.
"""

from __future__ import annotations

import numpy as np

TOL = 1e-3


def numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    """prog, ref: f32 [pixels, 3]."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(prog).all(axis=1)
    gap = np.abs(prog - ref) / (1.0 + np.abs(ref))
    off = ~finite | (np.nan_to_num(gap, nan=np.inf).max(axis=1) > TOL)
    return {"px_off_share": float(off.mean()),
            "nonfinite_px": int((~finite).sum())}


def verdict(nums: dict, limits: dict, frames_checked: int) -> dict:
    """{"correct": bool, "checks": {name: {"value", "limit"}}}: each number
    beside its limit (an upper limit; frames_checked a lower one)."""
    checks = {"frames_checked": {"value": frames_checked, "limit": 1}}
    ok = frames_checked >= 1
    if frames_checked:
        lim = limits["px_off_share"]["limit"]
        checks["px_off_share"] = {"value": nums["px_off_share"], "limit": lim}
        checks["nonfinite_px"] = {"value": nums["nonfinite_px"], "limit": 0}
        ok = ok and nums["px_off_share"] <= lim and nums["nonfinite_px"] == 0
    return {"correct": bool(ok), "checks": checks}


def lines(checks: dict) -> list:
    """One plain line per number compared, for the end of standard error."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in checks.items()]
