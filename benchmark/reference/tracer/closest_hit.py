"""Frozen copy of raytracer_project_tpu_torch/ops/closest_hit.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .constants import T_MAX

from .geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE

from . import intersect


CHUNK_PRIMS = 512


SLOTS = (
    ((0, 1, 2, 9), (3, 4, 5, 10, 11)),                   # sphere h, c
    ((0, 1, 2), (0, 1, 2, 6, 7, 8), (0, 1, 2, 6, 7, 8),  # det, u_num, v_num,
     (3, 4, 5, 11)),                                     # t_num
    ((0, 1, 2),) * 3 + ((3, 4, 5, 11),) * 3,             # box dl xyz, ol xyz
)


ROW_WIDTHS = (12, 20, 24)


SCAN_TILE = 128


class ScanTables(NamedTuple):
    """One scene's closest-hit tables, built once per scene (`scan_tables`)."""

    coeffs: tuple   # (sphere, tri, box) f32[16, G, C_pad]: the plain versions'
    rows: tuple     # (sphere, tri, box) f32[count, ROW_WIDTHS]: the kernels'
    bounds: tuple   # (sphere, tri, box) f32[C_pad / SCAN_TILE, 6] tile AABBs
    counts: tuple   # (n_spheres, n_tris, n_boxes) ints


def coarsen_bounds(fine: torch.Tensor, width: int = CHUNK_PRIMS) -> torch.Tensor:
    """Union MM_FINE-wide chunk AABBs [Cf, 6] into `width`-wide ones."""
    g = width // intersect.MM_FINE
    r = fine.reshape(-1, g, 6)
    return torch.cat([r[:, :, :3].amin(1), r[:, :, 3:].amax(1)], dim=1)


def compact_rows(coeff: torch.Tensor, count: int, slots, width: int):
    """The structural nonzeros of the first `count` columns of a [16, G,
    C_pad] table as prim-major rows f32[count, width]: output by output,
    each output's slots in ascending k, zeros after. Raises ValueError if
    any coefficient outside `slots` in those columns is not exactly 0."""
    cols = coeff[:, :, :count]
    listed = torch.zeros(cols.shape[:2], dtype=torch.bool)
    for g, ks in enumerate(slots):
        listed[list(ks), g] = True
    listed = listed.to(cols.device)
    stray = (cols[~listed] != 0).any(dim=1)
    if bool(stray.any()):
        k, g = torch.nonzero(~listed)[torch.nonzero(stray)[0, 0]].tolist()
        raise ValueError(f"coefficient table [16, {cols.shape[1]}, :]: slot "
                         f"k={k} of output {g} is not a structural zero")
    rows = torch.cat([cols[list(ks), g] for g, ks in enumerate(slots)]).T
    return torch.nn.functional.pad(rows, (0, width - rows.shape[1])).contiguous()


def scan_tables(scene) -> ScanTables:
    """The closest-hit tables of a scene with coefficient tables (scene.mm):
    the dense tables, their compact rows and the SCAN_TILE-wide tile AABBs,
    on the scene's device. Build once per scene, not per launch."""
    mm = scene.mm
    coeffs = (mm.sphere_coeff, mm.tri_coeff, mm.box_coeff)
    counts = (scene.spheres.count, scene.triangles.count,
              scene.boxes.count if scene.boxes is not None else 0)
    rows = tuple(compact_rows(c, n, s, w)
                 for c, n, s, w in zip(coeffs, counts, SLOTS, ROW_WIDTHS))
    bounds = tuple(coarsen_bounds(b, SCAN_TILE).contiguous()
                   for b in (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds))
    return ScanTables(coeffs=coeffs, rows=rows, bounds=bounds, counts=counts)


def closest_hit_plain(od, tmin: float, coeffs, counts):
    """Plain PyTorch K1. od f32[6, P]; coeffs = (sphere, tri, box) f32
    [16, G, C_pad]; counts = (n_spheres, n_tris, n_boxes)."""
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    return closest_hit_feats_plain(feats.T, tmin, coeffs, counts)


def closest_hit_feats_plain(feats, tmin: float, coeffs, counts):
    """Plain PyTorch K4: the closest hit of prebuilt features f32[16, N]."""
    feats = feats.T
    dev = feats.device
    p = feats.shape[0]
    a = feats[:, 12:13]
    featsk = intersect.splitk_feats(feats)
    tmin_c = torch.full((p, 1), tmin, dtype=torch.float32, device=dev)
    best_t = torch.full((p,), T_MAX, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((p,), dtype=torch.int32, device=dev)
    best_type = torch.zeros((p,), dtype=torch.int32, device=dev)
    epilogues = (
        lambda h, c, lo, hi: intersect.sphere_candidate_t_mm(h, c, a, lo, hi),
        intersect.triangle_candidate_t_mm,
        intersect.box_candidate_t_mm,
    )
    for coeff, n_rows, epi, ptype in zip(coeffs, counts, epilogues,
                                         (PRIM_SPHERE, PRIM_TRIANGLE, PRIM_BOX)):
        g = coeff.shape[1]
        # Columns past the table's count are not scanned (the reference
        # scans and masks them: the same result).
        for c0 in range(0, n_rows, CHUNK_PRIMS):
            w = min(CHUNK_PRIMS, n_rows - c0)
            block = coeff[:, :, c0:c0 + w].reshape(16, g * w)
            out = intersect.splitk_dot(featsk, intersect.splitk_pack_coeff(block))
            t = epi(*(out[:, i * w:(i + 1) * w] for i in range(g)),
                    tmin_c, best_t[:, None])
            cmin = t.amin(dim=1)
            iota = torch.arange(w, device=dev)
            carg = torch.where(t == cmin[:, None], iota[None, :], w).amin(dim=1)
            better = cmin < best_t
            best_t = torch.where(better, cmin, best_t)
            best_idx = torch.where(better, (c0 + carg).to(torch.int32), best_idx)
            best_type = torch.where(better, ptype, best_type).to(torch.int32)
    return best_t, best_idx, best_type

