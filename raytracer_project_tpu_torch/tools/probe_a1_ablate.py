"""P1: ablate the closest-hit kernel's internal costs on the card (twin of
the reference's tools/probe_a1_ablate.py, whose Pallas kernel this ports
as csrc/probe_a1_ablate.cu).

Variants: full | cheapepi (dots kept, epilogue ~free) | nodots (epilogue
on zeros, no dot work) | nocull (no tile skip). Each computes the best t
of every ray over a scene's sphere, triangle and box tables, as K1 does
(ops/closest_hit.py), and writes idx and type as 0:

  full      K1's scan;
  cheapepi  t = the raw group-0 dot of each primitive, no epilogue; its
            running minimum is what the cull compares against, so its
            result depends on how rays are grouped for the cull (a
            512-ray block over 512-wide chunks in the reference, a 32-ray
            warp over K1's 128-wide tiles on the card);
  nodots    the epilogues on zero dot outputs: T_MAX on every ray;
  nocull    full without the tile skip: the same t as full.

So full - cheapepi is about the epilogues' cost (an overestimate:
cheapepi's best t, a raw dot, culls more tiles than full's), full -
nodots the dots' (the rows' staging, loads and FMAs), nocull - full what
the cull saves.

`ablate` runs K1's own compact-row scan (csrc/closest_hit_sparse.cuh
tile_scan_kernel, instantiated per variant) on K1's ScanTables, so full's
t is K1's bit for bit.

    python -m raytracer_project_tpu_torch.tools.probe_a1_ablate [--device cpu]

runs the four variants on 262,144 rays of the showcase scene and prints
ms per launch. The rays are o = 3 N(0, 1), d = N(0, 1) per component,
the reference probe's distributions, drawn from a torch.Generator (not
JAX's numbers).
`ablate_plain` with the dense tables and their padded widths C_pad
repeats the reference probe, which scans the padding of each table's
last chunk (only cheapepi's result changes: a padded column's dot is 0,
which can win the minimum).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core.constants import T_MAX
from ..models import presets
from ..ops import closest_hit as k1
from ..ops import intersect
from . import arg_parser, build, time_ms

VARIANTS = ("full", "cheapepi", "nodots", "nocull")
P = 262_144
# The reference probe culls per block of this many rays; the kernels per warp.
BLOCK = 512
WARP = 32
# Rays per plain-version pass (bounds the [rays, G * tile] temporaries).
_SLAB = 16_384


def make_rays(p: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """od f32[6, p]: o = 3 N(0, 1), d = N(0, 1) per component."""
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((3, p), generator=g) * 3.0
    d = torch.randn((3, p), generator=g)
    return torch.cat([o, d]).to(device).contiguous()


def scene_tables(scene):
    """(coeffs, bounds, counts) of a scene for the dense scans (the
    reference probe's grouping here, K1's dense entries
    closest_hit_dense and closest_hit_feats_dense): the [16, G, C_pad]
    coefficient tables, their 512-wide chunk AABBs and the primitive
    counts."""
    mm = scene.mm
    coeffs = (mm.sphere_coeff, mm.tri_coeff, mm.box_coeff)
    bounds = tuple(k1.coarsen_bounds(b).contiguous()
                   for b in (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds))
    n_boxes = scene.boxes.count if scene.boxes is not None else 0
    return coeffs, bounds, (scene.spheres.count, scene.triangles.count, n_boxes)


def _slab(feats, tmin, coeffs, bounds, cols, variant, block):
    n = feats.shape[0]
    dev = feats.device
    a = feats[:, 12:13]
    o = feats[:, 3:6]
    dm = feats[:, 0:3]
    inv_d = 1.0 / torch.where(dm.abs() < 1e-30, torch.full_like(dm, 1e-30), dm)
    tmin_c = torch.full((n, 1), tmin, dtype=torch.float32, device=dev)
    best = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    epilogues = (lambda h, c, lo, hi: intersect.sphere_candidate_t_mm(
        h, c, a, lo, hi), intersect.triangle_candidate_t_mm,
                 intersect.box_candidate_t_mm)
    pad = (-n) % block
    for coeff, bnd, n_cols, epi in zip(coeffs, bounds, cols, epilogues):
        g = coeff.shape[1]
        width = coeff.shape[2] // bnd.shape[0]
        for c0 in range(0, n_cols, width):
            w = min(width, n_cols - c0)
            scan = None
            if variant != "nocull":
                lo = bnd[c0 // width, :3]
                hi = bnd[c0 // width, 3:]
                t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
                tn = torch.minimum(t0, t1).amax(1)
                tf = torch.maximum(t0, t1).amin(1)
                reach = (tn <= tf) & (tf > 0.0) & (tn < best) & (lo[0] <= hi[0])
                reach = torch.nn.functional.pad(reach, (0, pad))
                scan = reach.view(-1, block).any(1).repeat_interleave(block)[:n]
            if variant == "nodots":
                y = torch.zeros((n, g * w), dtype=torch.float32, device=dev)
            else:
                y = feats @ coeff[:, :, c0:c0 + w].reshape(16, g * w)
            groups = [y[:, i * w:(i + 1) * w] for i in range(g)]
            if variant == "cheapepi":
                t = groups[0]
            else:
                t = epi(*groups, tmin_c, best[:, None])
            new = torch.minimum(best, t.amin(1))
            best = new if scan is None else torch.where(scan, new, best)
    return best


def ablate_plain(od, tmin: float, coeffs, bounds, cols, variant: str,
                 block: int = WARP):
    """Plain PyTorch P1. od f32[6, P]; coeffs the [16, G, C_pad] tables;
    bounds their tile AABBs, whose count sets the tile width C_pad /
    len(bounds); cols = the columns to scan per table. Tiles are scanned
    in order and culled per `block` consecutive rays, each ray with its
    own running best. The card's grouping (the default): K1's ScanTables
    (128-wide tiles) and a warp of 32 -- the kernel stages a tile for its
    block only if some warp of it reaches the tile, so a warp's skip is
    the whole of the cull. The reference probe's: scene_tables' 512-wide
    chunks, every padded column and BLOCK. The dots are f32 products of the ray features and
    the coefficients. Returns (t f32[P], idx i32[P], type i32[P]), idx and
    type 0."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    slab = max(block, _SLAB // block * block)
    t = torch.cat([_slab(feats[s:s + slab], tmin, coeffs, bounds, cols,
                         variant, block)
                   for s in range(0, feats.shape[0], slab)])
    zero = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    return t, zero, zero.clone()


def ablate(od, tmin: float, tables: k1.ScanTables, variant: str):
    """P1 on the rays od f32[6, P] against a scene's ScanTables (what
    k1.closest_hit takes). CPU tensors take `ablate_plain` at the card's
    grouping; CUDA tensors launch csrc/probe_a1_ablate.cu's
    probe_a1_ablate, K1's compact-row scan. Returns (t, idx, type) as
    `ablate_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if od.device.type == "cpu":
        return ablate_plain(od, tmin, tables.coeffs, tables.bounds,
                            tables.counts, variant)
    out = k1._outputs(od, od.shape[1])
    kernels.launch("probe_a1_ablate", VARIANTS.index(variant),
                   *k1.scan_args(od, od.shape[1], tmin, tables), 0, *out)
    kernels.count(ablate)
    return out


ablate.launches = 0


def compare(variant: str, t, ref) -> dict:
    """How the kernel's t holds against the plain version's `ref` (same
    grouping): `ok` under P1's budgets. full/nocull: the miss sets differ on
    <= 1% of rays, >= 97% of the common hits within 5e-3 relative and none
    over 5e-2 (the dots are summed in another order); nodots: T_MAX on
    every ray; cheapepi (a minimum that steers its own cull): <= 0.5% of
    rays off by more than 1e-4 relative. Also the count of rays below T_MAX,
    of rays whose t differs at all, and the largest |dt| where both are
    below T_MAX."""
    n = t.shape[0]
    ht, hr = t < T_MAX, ref < T_MAX
    both = ht & hr
    rel = (t - ref).abs() / ref.abs().clamp(min=1e-3)
    stats = {"hits": int(ht.sum()), "flips": int((ht != hr).sum()),
             "differ": int((t != ref).sum()),
             "max_abs_err": float((t - ref).abs()[both].max()) if bool(
                 both.any()) else 0.0}
    if variant == "nodots":
        ok = bool((t == T_MAX).all()) and bool((ref == T_MAX).all())
    elif variant == "cheapepi":
        ok = int((rel > 1e-4).sum()) <= n // 200
    else:
        r = rel[both]
        ok = (stats["flips"] <= n // 100
              and (r.numel() == 0 or (float((r <= 5e-3).float().mean()) >= 0.97
                                      and float(r.max()) <= 5e-2)))
    stats["ok"] = bool(ok)
    return stats


def run(variant: str, od, tables: k1.ScanTables, n: int = 10) -> dict:
    """One variant at tmin 0 (the probe's): ms per launch over `n` launches
    a round (`time_ms`) and the t of the last, printed as the reference
    probe prints it."""
    out = []
    ms = time_ms(lambda: out.append(ablate(od, 0.0, tables, variant)[0]),
                 od.device, n)
    t = out[-1]
    hits = int((t < T_MAX).sum())
    print(f"{variant:16s} {ms:7.3f} ms  ({od.shape[1]} rays, {hits} below "
          f"T_MAX)", flush=True)
    return {"variant": variant, "ms": ms, "t": t}


def main(device="cuda", p: int = P, seed: int = 0) -> dict:
    """Every variant on `p` rays of the showcase scene; returns the runs by
    variant."""
    dev = torch.device(device)
    build("probe_a1_ablate", dev)
    od = make_rays(p, seed, dev)
    tables = k1.scan_tables(presets.showcase_scene().to(dev))
    return {v: run(v, od, tables) for v in VARIANTS}


if __name__ == "__main__":
    main(arg_parser(__doc__).parse_args().device)
