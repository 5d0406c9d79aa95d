"""BVH wireframe debug visualization (twin of
raytracer_project_tpu/ops/debugviz.py).

The reference engine's in-traversal debug rendering (bvh.hpp:46-110,
aabb.hpp:68-84, camera.hpp:937-953): nodes at the selected tree level
render neon box edges (depth-keyed color `(0.4, min(depth*0.15, 1), 1-g) *
4`), geometry under a selected node gets a dim volume tint `* 0.1`, other
geometry renders dark (0.01), misses are black. `level = -1` isolates
leaves (bvh.hpp:67-69); thickness scales with hit distance for perspective
(bvh.hpp:66). As in the reference package, the nearest edge along the ray
wins (the engine returns the first edge in DFS order).

The edge scan walks the flat BVH (ops/bvh.py FlatBVH) in lock-step torch
ops, as ops/traverse.py does: each lane holds one node index, descends
into every box it crosses and otherwise follows the escape link, so it
visits every node its ray passes through. The surface t comes from
intersect.intersect with the scene's hit tables (K4 on the card).
"""

from __future__ import annotations

import torch

from ..core import rng, vecmath
from ..core.constants import T_MAX, T_MIN
from ..models import camera as camera_mod
from . import intersect
from .traverse import STOP_CHECK_EVERY


def _edge_color(level):
    """Depth-keyed neon (bvh.hpp:79-83)."""
    g = torch.clamp(level.to(torch.float32) * 0.15, max=1.0)
    return torch.stack([torch.full_like(g, 0.4), g, 1.0 - g], dim=-1)


def bvh_edge_scan(scene, o, d, *, level: int = -1, thickness: float = 0.01):
    """Nearest selected-node box-edge crossing per ray.

    Returns (edge_t [N] f32, T_MAX where none; edge_lvl [N] i32; any_sel
    [N] bool, the ray passed through some selected node's box). The
    traversal core shared by the standalone wireframe view and the
    composited-into-beauty overlay. The hit points on the box faces are
    o + t d as one fused multiply-add, the rounding of the reference's
    compiled loop body."""
    bvh = scene.bvh
    n = o.shape[0]
    dev = o.device
    tiny = torch.where(d < 0, -1e-20, 1e-20)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)

    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    edge_t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    edge_lvl = torch.zeros((n,), dtype=torch.int32, device=dev)
    any_sel = torch.zeros((n,), dtype=torch.bool, device=dev)
    escape = bvh.escape.to(torch.int64)
    # "Is any lane still walking" is a host read, taken every
    # STOP_CHECK_EVERY steps; the steps after the last lane ends are no-ops.
    step = 0
    while step % STOP_CHECK_EVERY or bool((node >= 0).any()):
        step += 1
        live = node >= 0
        ni = torch.clamp(node, min=0)
        nmin = bvh.node_min[ni]
        nmax = bvh.node_max[ni]
        t0 = (nmin - o) * inv_d
        t1 = (nmax - o) * inv_d
        t_near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=T_MIN)
        t_far = torch.maximum(t0, t1).amin(-1)
        box_hit = live & (t_near <= t_far)

        is_leaf = bvh.count[ni] > 0
        node_level = bvh.node_level[ni]
        selected = is_leaf if level == -1 else node_level == level

        # Perspective-scaled thickness (bvh.hpp:66).
        thick = (thickness * (0.05 + t_near * 0.1))[:, None]

        def on_edge(t):
            # >= 2 near-planes => edge/corner (aabb.hpp:68-84).
            p = vecmath.fma(t[:, None], d, o)
            near = (torch.abs(p - nmin) < thick) | (torch.abs(p - nmax) < thick)
            return near.sum(-1) >= 2

        entry_edge = on_edge(t_near + 1e-4)
        exit_edge = on_edge(t_far - 1e-4)
        is_edge = box_hit & selected & (entry_edge | exit_edge)
        t_hit = torch.where(entry_edge, t_near, t_far)

        better = is_edge & (t_hit < edge_t)
        edge_t = torch.where(better, t_hit, edge_t)
        edge_lvl = torch.where(better, node_level, edge_lvl)
        any_sel = any_sel | (box_hit & selected)

        # Visit everything: descend internal hits, escape otherwise.
        nxt = torch.where(box_hit & ~is_leaf, ni + 1, escape[ni])
        node = torch.where(live, nxt, node)
    return edge_t, edge_lvl, any_sel


def _surface_hit(scene, o, d):
    return intersect.intersect(scene, o, d, T_MIN, intersect.hit_tables(scene))


def bvh_debug_trace(scene, o, d, *, level: int = -1, thickness: float = 0.01):
    """Wireframe radiance for each ray [N, 3]."""
    edge_t, edge_lvl, any_sel = bvh_edge_scan(scene, o, d, level=level,
                                              thickness=thickness)
    edge_hit = edge_t < T_MAX
    color = _edge_color(edge_lvl)

    # Geometry beneath: dark or volume-tinted (bvh.hpp:98-102,
    # camera.hpp:947-953).
    geo = _surface_hit(scene, o, d)
    geo_color = torch.where((geo.hit & any_sel)[:, None], color * 0.1,
                            torch.where(geo.hit[:, None], 0.01, 0.0))
    return torch.where(edge_hit[:, None], color * 4.0, geo_color)


def _center_rays(cam, h: int, w: int, device):
    """Pixel-center rays (the reference's get_center_ray, camera.hpp:806):
    deterministic, no jitter, for a stable debug overlay."""
    cam = cam.to(device)
    ii = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    jj = torch.arange(h, dtype=torch.float32,
                      device=device).repeat_interleave(w)
    d = (cam.pixel00[None, :] + ii[:, None] * cam.pixel_delta_u[None, :]
         + jj[:, None] * cam.pixel_delta_v[None, :] - cam.center[None, :])
    return cam.center.expand_as(d), d


def composite_wireframe(scene, cam: camera_mod.Camera, beauty, *,
                        level: int = -1, thickness: float = 0.01):
    """Blend the BVH wireframe INTO a rendered beauty buffer.

    The reference engine renders node edges as fabricated diffuse_light
    hits inside the traversal, so wires and geometry occlude each other by
    t and the wireframe appears over the LIVE render (bvh.hpp:56-109,
    blended at camera.hpp:937-953). This is that composite at primary
    visibility: pixels whose center ray crosses a selected node's box edge
    BEFORE its first surface hit take the emissive edge color; everything
    else keeps the path-traced beauty. Secondary bounces don't see the
    wire (a mirror won't reflect the debug lines), as in the reference
    package.

    beauty: [H, W, 3] linear radiance (accumulator average, pre-post) on
    the scene's device. Returns the composited [H, W, 3] linear buffer."""
    h, w = beauty.shape[0], beauty.shape[1]
    o, d = _center_rays(cam, h, w, beauty.device)
    edge_t, edge_lvl, _ = bvh_edge_scan(scene, o, d, level=level,
                                        thickness=thickness)
    geo = _surface_hit(scene, o, d)
    surf_t = torch.where(geo.hit, geo.t, T_MAX)
    wire = (edge_t < T_MAX) & (edge_t < surf_t)
    out = torch.where(wire[:, None], _edge_color(edge_lvl) * 4.0,
                      beauty.reshape(-1, 3))
    return out.reshape(h, w, 3)


def render_bvh_debug(scene, cam: camera_mod.Camera, key, config, *,
                     level: int = -1, thickness: float = 0.01):
    """Full-frame wireframe render [H, W, 3] on the scene's device (one
    sample; deterministic enough for a debug view). key: an integer seed
    or an rng.Key; the jittered camera rays take the reference's per-pixel
    threefry draws of PRNGKey(seed), bit for bit."""
    if not isinstance(key, rng.Key):
        key = rng.Key(0, int(key))
    dev = scene.spheres.center.device
    cam = cam.to(dev)
    pixel_ids = torch.arange(config.n_pixels, device=dev)
    (jx, jy), (r0, r1) = rng.camera_draws_threefry(key, pixel_ids)
    ii, jj = camera_mod.pixel_rowcol_f32(pixel_ids, config.width)
    px = (ii + jx)[:, None]
    py = (jj + jy)[:, None]
    sample = cam.pixel00 + px * cam.pixel_delta_u + py * cam.pixel_delta_v
    o = (cam.center + r0[:, None] * cam.defocus_disk_u
         + r1[:, None] * cam.defocus_disk_v)
    img = bvh_debug_trace(scene, o, sample - o, level=level,
                          thickness=thickness)
    return img.reshape(config.height, config.width, 3)
