"""Intersector A/B across scene sizes (twin of tools/bench_bvh.py): the
threaded-BVH traversal (ops/traverse.py, torch ops) against K4, the
compact-row closest-hit kernel (ops/closest_hit.py, through
intersect.intersect), on the same rays; and the fused pool's two closest
hits, K1's tile scan and the BVH kernel (closest_hit.bvh_closest_hit,
csrc/bvh_hit.cu), whose times give the crossover of BVH_MIN_PRIMS.

    python -m raytracer_project_tpu_torch.tools.bench_bvh [--device cpu]

Cases: the reference tool's (the showcase at grids 8, 15, 30 and 45, and
the sphere funnel at 8,192 spheres with mesh_detail 2 and at 16,384 with
4), and the funnel at 65,536 spheres with mesh_detail 6 (116,226
primitives). Rays: 262,144 mixed, half the camera rays of the scene's bench
camera (bench.py's showcase or funnel camera, 512x256, seed 0) and half one
diffuse-or-specular scatter of them (shade.scatter at their first hits;
lanes whose camera ray missed keep it). Each is timed as the best of three
calls after a warm-up, host clock around a synchronised call; one JSON row
per case, with the fraction of rays on which the traversal and K4 agree
(same hit flag, |dt| < 1e-3), the traversal's steps, the native SAH
build's milliseconds and, on the card, the lanes on which the BVH kernel
and K1 differ (hit, winner, or t in its bits where both chose the same
primitive).
"""

from __future__ import annotations

import json
import time

import torch

from . import arg_parser

N_RAYS = 262_144
REPS = 3
CASES = ([("showcase", dict(grid=g, with_bvh=True, with_meshes=True))
          for g in (8, 15, 30, 45)]
         + [("funnel", dict(n_spheres=8192, mesh_detail=2)),
            ("funnel", dict(n_spheres=16384, mesh_detail=4)),
            ("funnel", dict(n_spheres=65536, mesh_detail=6))])


def mixed_rays(scene, kind: str, n: int, device):
    """n rays on `device`: n/2 camera rays and one scatter of each."""
    from ..bench import FUNNEL_CAM, SHOWCASE_CAM
    from ..core import rng
    from ..models import camera
    from ..ops import intersect, shade

    width = 512
    height = n // 2 // width
    cam = camera.make_camera(image_width=width, image_height=height,
                             **(FUNNEL_CAM if kind == "funnel" else
                                SHOWCASE_CAM)).to(device)
    pix = torch.arange(width * height, device=device)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = camera.generate_rays(cam, lr, pix, width)
    hit = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, hit), d, lr)
    keep = hit.hit[:, None]
    return (torch.cat([o, torch.where(keep, sc.origin, o)]).contiguous(),
            torch.cat([d, torch.where(keep, sc.direction, d)]).contiguous())


def _best_s(fn, device, reps: int = REPS):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def measure(scene, o, d, device, tmin: float = 1e-3) -> dict:
    """Time the traversal and K4 (intersect.intersect on the "k4" route) on
    the rays o, d and compare their hits; scene on `device`."""
    from ..ops import closest_hit, intersect, traverse

    tables = closest_hit.scan_tables(scene)
    stats: dict = {}
    t_bvh, h_bvh = _best_s(
        lambda: traverse.intersect_bvh(scene, o, d, tmin, stats), device)

    def k4():
        t, idx, typ = closest_hit.closest_hit_feats(
            intersect.ray_feature_rows(o, d).contiguous(), tmin, tables)
        return intersect.Hit(t=t, prim_type=typ, prim_idx=idx, hit=t < 1e30)

    t_k4, h_k4 = _best_s(k4, device)
    dt = torch.abs(torch.where(h_bvh.hit, h_bvh.t, 0.0)
                   - torch.where(h_k4.hit, h_k4.t, 0.0))
    agree = float(((h_bvh.hit == h_k4.hit) & (dt < 1e-3)).float().mean())
    n = o.shape[0]
    row = {"primitives": int(scene.primitive_count),
           "bvh_nodes": scene.bvh.node_count, "bvh_depth": scene.bvh.n_levels,
           "bvh_steps": stats["iterations"] // (1 + REPS),
           "bvh_ms": t_bvh * 1e3, "k4_ms": t_k4 * 1e3,
           "bvh_mrays_s": n / t_bvh / 1e6, "k4_mrays_s": n / t_k4 / 1e6,
           "hit_agreement": agree}
    if device.type == "cuda":
        row.update(pool_closest_hits(scene, o, d, tables, device, tmin))
    return row


def pool_closest_hits(scene, o, d, tables, device, tmin: float) -> dict:
    """The fused pool's closest hit on the rays o, d, timed: K1's tile scan
    and the BVH kernel over the scene's own tree (CUDA only), and the lanes
    on which their answers differ."""
    from ..ops import bvh, closest_hit

    od = torch.cat([o.T, d.T]).contiguous()
    with_tree = tables._replace(bvh=bvh.hit_bvh(scene))
    t_k1, h_k1 = _best_s(lambda: closest_hit.closest_hit(od, tmin, tables),
                         device)
    t_bk, h_bk = _best_s(lambda: closest_hit.closest_hit(od, tmin, with_tree),
                         device)
    hit_a, hit_b = h_k1[0] < 1e30, h_bk[0] < 1e30
    same = hit_a & hit_b & (h_k1[1] == h_bk[1]) & (h_k1[2] == h_bk[2])
    bits = h_k1[0].view(torch.int32) != h_bk[0].view(torch.int32)
    n = od.shape[1]
    return {"k1_ms": t_k1 * 1e3, "bvh_kernel_ms": t_bk * 1e3,
            "bvh_kernel_mrays_s": n / t_bk / 1e6,
            "k1_vs_bvh_kernel": {"hit_flips": int((hit_a != hit_b).sum()),
                                 "winner_flips": int((hit_a & hit_b
                                                      & ~same).sum()),
                                 "t_bits_differ": int((same & bits).sum())}}


def main(device: str = "cuda", n_rays: int = N_RAYS, cases=CASES) -> list:
    from .. import native
    from ..models import presets

    dev = torch.device(device)
    rows = []
    from ..ops import bvh

    for kind, kw in cases:
        t0 = time.perf_counter()
        scene = (presets.showcase_scene(**kw) if kind == "showcase"
                 else presets.bvh_stress_scene(**kw))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bvh.build_bvh(scene)
        sah_ms = 1e3 * (time.perf_counter() - t0)
        scene = scene.to(dev)
        o, d = mixed_rays(scene, kind, n_rays, dev)
        row = {"scene": f"{kind}:{kw}", "rays": o.shape[0],
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "builder": native.version() or "python",
               "scene_build_s": build_s, "bvh_build_ms": sah_ms,
               **measure(scene, o, d, dev)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(arg_parser(__doc__).parse_args().device)
