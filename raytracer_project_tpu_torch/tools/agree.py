"""How a CUDA kernel's outputs must agree with its plain PyTorch version's:
the budgets of the card tests (tests/test_torch_cuda.py), in one place,
so that chip_smoke.py holds each kernel it times, on its path's inputs,
to the same ones.

Each check raises AssertionError naming what went over its budget, and
returns the largest difference it allowed (0.0 where it asks for the same
bits); chip_smoke.py writes that number into the kernel's entry.
"""

from __future__ import annotations

import torch

from ..ops import fused_step as fs

# A closest hit's "no hit" (intersect.T_MAX), and the distance from a
# bounce ray's origin within which a hit is a near-origin hit: the funnel's
# spheres overlap, so a bounce ray can start inside or just outside a
# neighbour, and each formulation's rounding decides that root.
T_MISS = 1e30
NEAR_ORIGIN = 0.02
# K2's record rows that hold integers (exact); the others are floats.
RECORD_INT_ROWS = (fs._RO_HIT, fs._RO_FRONT, fs._RO_MTYPE, fs._RO_GU,
                   fs._RO_GV, fs._RO_HASB, fs._RO_TEXROW, fs._RO_BUMPROW,
                   fs._RO_ENVROW)
# The rows P3's stages 1 and 2 decode in floats; stage 0 only fetches.
STAGE_FLOAT_ROWS = tuple(range(2, 11)) + (12, 13)


def stage_exact_rows(stage: int) -> tuple:
    """The record rows P3's stage `stage` must match exactly."""
    floats = STAGE_FLOAT_ROWS if stage else ()
    return tuple(k for k in range(fs._RO_ROWS) if k not in floats)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bits(out) -> torch.Tensor:
    """The f32 result of a fetch (a tensor or a tuple of them) as i32."""
    if isinstance(out, torch.Tensor):
        return out.view(torch.int32) if out.dtype == torch.float32 else out
    return torch.stack(out).view(torch.int32) if out else torch.zeros(0)


def same_bits(out, ref, name: str = "") -> float:
    """out and ref (a tensor or a tuple of them) of the same dtypes and
    shapes, equal bit for bit."""
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    refs = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    check(len(outs) == len(refs), f"{name}: {len(outs)} outputs, not "
          f"{len(refs)}")
    for k, (a, b) in enumerate(zip(outs, refs)):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{name}: output {k} is {a.dtype} {tuple(a.shape)}, not "
              f"{b.dtype} {tuple(b.shape)}")
        check(torch.equal(bits(a), bits(b)), f"{name}: output {k}: "
              f"{int((bits(a) != bits(b)).sum())} values differ in bits")
    return 0.0


def finite_t_equal(t, ref, od) -> bool:
    """t equals ref bit for bit on every lane of the rays od f32[6, P]
    whose features are finite (a dense chain turns an inf feature into NaN
    through inf * 0, the compact chain does not)."""
    from ..ops import intersect

    feats = intersect.ray_feature_rows(od[:3].T, od[3:].T)
    finite = torch.isfinite(feats[:13]).all(0)
    return torch.equal(t[finite].view(torch.int32),
                       ref[finite].view(torch.int32))


def hit_budgets(got, want, near=None, name: str = "") -> float:
    """Two closest hits (t, idx, type) under the reference's budgets
    (utils/smoke.py stage_hit_agree): hit flips <= max(2, 1%), winner
    flips <= max(2, 2.5%), and among same-winner lanes at most 3% over
    5e-3 relative in t and none over 5e-2, but on the lanes `near` (a
    mask: near-origin or grazing hits, whose root each formulation's
    rounding decides), which count in the 3% only. Returns the largest
    |dt| held to the cap."""
    tk, ik, yk = got
    tp, ip, yp = want
    n = tk.shape[0]
    hk, hp = tk < T_MISS, tp < T_MISS
    flips = int((hk != hp).sum())
    check(flips <= max(2, n // 100), f"{name}: {flips} hit flips of {n}")
    both = hk & hp
    same = both & (ik == ip) & (yk == yp)
    winner = int((both & ~same).sum())
    check(winner <= max(2, n // 40), f"{name}: {winner} winner flips of {n}")
    if not bool(same.any()):
        return 0.0
    rel = (tk - tp).abs() / tp.abs().clamp(min=1e-3)
    frac = float((rel[same] > 5e-3).float().mean())
    check(frac <= 0.03, f"{name}: {frac:.4f} of same-winner t over 5e-3")
    held = same if near is None else same & ~near
    if not bool(held.any()):
        return 0.0
    worst = float(rel[held].max())
    check(worst <= 5e-2, f"{name}: same-winner t off by {worst:.3g}")
    return float((tk - tp).abs()[held].max())


def near_origin(left, got, t_ref) -> torch.Tensor:
    """Bounce lanes whose hit `got` (t, idx, type) is near their origin:
    the primitive the lane left (left = (idx, type, hit) of its first
    hit), or any hit of got or t_ref within NEAR_ORIGIN."""
    t, idx, typ = got
    return ((left[2] & (idx == left[0]) & (typ == left[1]))
            | (torch.minimum(t, t_ref) < NEAR_ORIGIN))


def grazing(scene, o, d, t, idx, typ) -> torch.Tensor:
    """Lanes whose hit is met so nearly tangentially that f32 cannot
    resolve t to 5e-2: an error of 8 ulps of the largest term each
    formulation sums, carried to t in f64 -- a sphere's
    c = |o|^2 - 2 o.C + |C|^2 - r^2 moves a root by dc / (2 sqrt(disc)); a
    triangle's t = (o - v0).n / (-d.n) by the numerator's and the
    denominator's errors over |d.n|."""
    from ..models.geometry import PRIM_SPHERE, PRIM_TRIANGLE

    f64, ulps = torch.float64, 8 * 2.0 ** -23
    o64, d64, t64 = o.to(f64), d.to(f64), t.to(f64).abs()
    norm = lambda x: torch.sqrt((x * x).sum(-1))
    sph, tri = typ == PRIM_SPHERE, typ == PRIM_TRIANGLE
    row = torch.where(sph, idx, 0).long()
    c = scene.spheres.center[row].to(f64)
    r = scene.spheres.radius[row].to(f64)
    oc = c - o64
    h = (d64 * oc).sum(-1)
    disc = h * h - (d64 * d64).sum(-1) * ((oc * oc).sum(-1) - r * r)
    mag = (o64 * o64).sum(-1) + (c * c).sum(-1) + r * r
    dt_sph = ulps * mag / (2.0 * torch.sqrt(disc.clamp(min=1e-300)))
    row = torch.where(tri, idx, 0).long()
    v0 = scene.triangles.v0[row].to(f64)
    n = torch.linalg.cross(scene.triangles.e1[row].to(f64),
                           scene.triangles.e2[row].to(f64), dim=-1)
    det = (d64 * n).sum(-1).abs().clamp(min=1e-300)
    dt_tri = ulps * norm(n) * (norm(o64) + norm(v0) + t64 * norm(d64)) / det
    dt = torch.where(sph, dt_sph, torch.where(tri, dt_tri, 0.0))
    return (t < T_MISS) & (dt > 5e-2 * t64)


def against_k1(got, k1_hits, name: str = "") -> dict:
    """The BVH kernel's hits against K1's tile scan on the same rays: t
    bit for bit on every lane where both chose the same primitive, hit and
    winner flips within the reference's budgets. Returns the counts."""
    tb, ib, yb = got
    tk, ik, yk = k1_hits
    n = tb.shape[0]
    hb, hk = tb < T_MISS, tk < T_MISS
    both = hb & hk
    same = both & (ib == ik) & (yb == yk)
    t_bits = int((same & (tb.view(torch.int32) != tk.view(torch.int32)))
                 .sum())
    out = {"hits": int(both.sum()), "hit_flips": int((hb != hk).sum()),
           "winner_flips": int((both & ~same).sum()), "t_bits_differ": t_bits}
    check(t_bits == 0, f"{name}: {t_bits} same-primitive t differ from K1's")
    check(out["hit_flips"] <= max(2, n // 100), f"{name}: {out}")
    check(out["winner_flips"] <= max(2, n // 40), f"{name}: {out}")
    return out


def rows_agree(out, ref, exact=(), name: str = "") -> float:
    """out and ref, row by row (the rows of a tensor, or the tensors of a
    tuple): integer rows and the rows `exact` equal, float rows within
    1e-5 abs + 1e-5 rel. Returns the largest |d| over the float rows."""
    err = 0.0
    check(len(out) == len(ref), f"{name}: {len(out)} rows, not {len(ref)}")
    for k, (a, b) in enumerate(zip(out, ref)):
        check(a.shape == b.shape, f"{name}: row {k} of shape "
              f"{tuple(a.shape)}, not {tuple(b.shape)}")
        if k in exact or not a.dtype.is_floating_point:
            check(torch.equal(a, b), f"{name}: row {k}: "
                  f"{int((a != b).sum())} values differ")
        elif a.numel():
            ok = torch.isclose(a, b, rtol=1e-5, atol=1e-5)
            d = float((a - b).abs().max())
            check(bool(ok.all()), f"{name}: row {k}: {int((~ok).sum())} "
                  f"values off, max |d| {d:.3g}")
            err = max(err, d)
    return err


def differing_lanes(out, ref) -> torch.Tensor:
    """The lanes (columns) where any row of the state tensors out differs
    from ref's: integer rows at all, float rows beyond 1e-5 abs + 1e-5
    rel."""
    bad = torch.zeros(out[0].shape[-1], dtype=torch.bool,
                      device=out[0].device)
    for a, b in zip(out, ref):
        check(a.shape == b.shape, f"state rows {tuple(a.shape)}, not "
              f"{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            bad |= ~torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
        else:
            bad |= (a != b).any(0)
    return bad


def fused_step(tables, hits, state, aparams, bparams, sp,
               lane_budget: int = 0, name: str = "",
               acc_tol: float = 1e-5) -> tuple:
    """K3 fused (fs.shade_accumulate) against its plain version on the same
    inputs, each into an accumulator of its own: the state rows
    (`differing_lanes`) on all but `lane_budget` lanes (a fog flight may
    flip on an ulp of the card's logf); the accumulator within acc_tol abs
    + rel on every pixel no differing lane finishes into (1e-5 where each
    address gets at most one add in the step; where two lanes of a pixel
    can finish in one step their adds land in either order), its dummy
    slots untouched; the
    segment and step counts equal, next_work and the live count too where
    no lane differs; the counts of segments that end in a medium within
    `lane_budget` of each other (0 without fog); every lane's pixel inside
    the step's window. Returns the largest |d| of the accumulator and the
    kernel's accumulator [channels, pixels]."""
    sf, si, nw, seg = state
    dev, n = sf.device, sp.n_pixels
    outs, accs, scatters = [], [], []
    for fn in (fs.shade_accumulate, fs.shade_accumulate_plain):
        acc = fs.new_accumulator(sp, dev)
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        scatters.append(torch.zeros(1, dtype=torch.int64, device=dev))
        outs.append(fn(tables, hits, sf, si, nw, seg, steps, aparams,
                       bparams, sp, acc, scatters[-1]))
        accs.append(acc.view(len(fs.acc_channels(sp)), n + 1))
    out, ref = outs
    bad = differing_lanes(out[:2], ref[:2])
    n_bad = int(bad.sum())
    check(n_bad <= lane_budget, f"{name}: {n_bad} lanes differ (budget "
          f"{lane_budget})")
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[si[3][bad].long() - sp.pixel_offset] = False
    a, b = accs[0][:, :n][:, keep], accs[1][:, :n][:, keep]
    ok = torch.isclose(a, b, rtol=acc_tol, atol=acc_tol)
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(bool(ok.all()), f"{name}: accumulator: {int((~ok).sum())} values "
          f"off, max |d| {err:.3g}")
    check(not bool(accs[0][:, n].any()), f"{name}: a dummy slot was added to")
    check(int(out[3]) == int(ref[3]), f"{name}: segment count")
    check(int(out[5]) == int(ref[5]) == 1, f"{name}: step count")
    card, plain = (int(x) for x in scatters)
    check(abs(card - plain) <= lane_budget and (sp.n_volumes > 0 or plain == 0),
          f"{name}: scatter count {card}, plain {plain}")
    if not n_bad:
        check(torch.equal(out[2], ref[2]) and torch.equal(out[4], ref[4]),
              f"{name}: next_work or the live count")
    li = out[1][3]
    check(bool(((li >= sp.pixel_offset) & (li < sp.pixel_offset + n)).all()),
          f"{name}: a lane's pixel is outside the window")
    return err, accs[0][:, :n]
