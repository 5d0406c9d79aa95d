"""The fused pooled-wavefront step (twin of
raytracer_project_tpu/ops/fused_step.py, beauty subset).

A pool of P lanes traces one path segment per step. Each step is three
kernels and one scatter-add:

  K1 closest hit    ops/closest_hit.py         (csrc/closest_hit.cu)
  K2 decode         `decode` below             (csrc/decode.cu)
  K3 shade-advance  `shade_advance` below      (csrc/shade_advance.cu)
  accumulator       Tensor.index_add_ of finished-path radiance

Per-sample semantics are the reference's: same RNG contexts, constants
and update order, so a lane's path depends only on (seed, pixel, sample).
The texel, bump and environment row gathers that the reference runs as
XLA ops between its kernels are direct loads inside K3 here.

Every kernel has a plain PyTorch version in this module; a wrapper takes
it for CPU tensors and launches the CUDA kernel (or raises) for CUDA
tensors.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import rng, soa, vecmath
from ..core.constants import (
    PI, RAY_EPSILON, RR_P_MAX, RR_P_MIN, RR_START_BOUNCE, T_MAX, T_MIN,
    WEAK_RAY_EPS,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models import materials as mat_mod
from ..models import textures as tex_mod
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from . import closest_hit as k1
from .intersect import (
    _BOX_DEFAULT_ROW, _SPHERE_DEFAULT_ROW, _TRI_DEFAULT_ROW, _box_record_soa,
    _packed_all, _sphere_record_soa, _triangle_record_soa,
)

# The pool is rounded up to a multiple of the reference's kernel-B block,
# so that a pool of a given size maps lanes to work exactly as it does.
B_BLOCK = 4096
DEFAULT_POOL_LANES = 131_072
# On the card the loop decides whether to run step k from the live-lane
# count after step k - LIVE_LAG, copied to pinned host memory without a
# sync: the host stays that many steps ahead of the card, and at most
# LIVE_LAG - 1 no-op steps run after the pool drains. The CPU reads the
# count of the step just taken.
LIVE_LAG = 2

# K2 output rows ([24, P] f32).
_RO_HIT = 0
_RO_T = 1
_RO_N = 2        # 2:5 shading normal
_RO_TAN = 5      # 5:8 tangent
_RO_BIT = 8      # 8:11 bitangent
_RO_FRONT = 11
_RO_MTYPE = 12
_RO_PARAM = 13
_RO_BSTR = 14
_RO_BASE = 15    # 15:18 base color (checker / solid / missing-cyan)
_RO_GU = 18      # bump u-crossing gate
_RO_GV = 19
_RO_HASB = 20
_RO_TEXROW = 21  # flat atlas row (-1 = use base color)
_RO_BUMPROW = 22
_RO_ENVROW = 23  # equirect HDR row (HDR mode; 0 otherwise)
_RO_ROWS = 24

# K3 camera/environment parameter vector (f32 [40]).
_BP_CENTER = 0
_BP_P00 = 3
_BP_DU = 6
_BP_DV = 9
_BP_DDU = 12
_BP_DDV = 15
_BP_SUN_DIR = 18
_BP_SUN_COL = 21
_BP_SUN_INT = 24
_BP_SUN_SIZE = 25
_BP_INTENSITY = 26
_BP_BG = 27

# Work-id cap: respawn decodes (pixel, sample) from the work id in f32,
# exact only below 2^24; larger renders are sample-chunked.
_TOTAL_WORK_CAP = 1 << 24


class FusedTables(NamedTuple):
    """Scene constants read by the kernels: plain f32 row-major tables."""

    coeffs: tuple        # (sphere, tri, box) f32[16, G, C_pad]
    bounds: tuple        # (sphere, tri, box) f32[C_pad/512, 6]
    counts: tuple        # (n_spheres, n_tris, n_boxes) ints
    rectab: torch.Tensor     # f32[Ntot, 28] packed primitive shading rows
    mattab: torch.Tensor     # f32[M, 8] albedo rgb, param, mtype, tex, bump, bstr
    texmeta: torch.Tensor    # f32[K, 10] kind, w, h, inv_scale, even rgb, odd rgb
    atlas_rows: torch.Tensor  # f32[K*AH*AW, 4] texels (r, g, b, 0)
    grad_rows: torch.Tensor   # f32[K*AH*AW, 2] bump neighbour deltas
    env_rows: torch.Tensor    # f32[EH*EW, 4] HDR texels (zeros [1, 4] unless HDR)
    atlas_hw: tuple      # (AH, AW)
    env_hw: tuple | None  # (EH, EW) in HDR mode


def build_tables(scene, env, env_mode: int) -> FusedTables:
    """Kernel tables from a scene (any device)."""
    m = scene.materials
    f32 = lambda x: x.to(torch.float32)
    mattab = torch.stack(
        [m.albedo[:, 0], m.albedo[:, 1], m.albedo[:, 2], m.param,
         f32(m.mtype), f32(m.texture_id), f32(m.bump_id), m.bump_strength],
        dim=1)
    bank = scene.textures
    texmeta = torch.stack(
        [f32(bank.kind), f32(bank.size[:, 0]), f32(bank.size[:, 1]),
         bank.checker_inv_scale, bank.checker_even[:, 0],
         bank.checker_even[:, 1], bank.checker_even[:, 2],
         bank.checker_odd[:, 0], bank.checker_odd[:, 1],
         bank.checker_odd[:, 2]], dim=1)
    pad1 = lambda x: torch.nn.functional.pad(x, (0, 1))
    env_hw = None
    env_rows = torch.zeros((1, 4), dtype=torch.float32, device=mattab.device)
    if env_mode == env_mod.HDR_MAP:
        env_hw = (int(env.hdr_image.shape[0]), int(env.hdr_image.shape[1]))
        env_rows = pad1(env.hdr_image.reshape(-1, 3))
    mm = scene.mm
    n_boxes = scene.boxes.count if scene.boxes is not None else 0
    return FusedTables(
        coeffs=(mm.sphere_coeff, mm.tri_coeff, mm.box_coeff),
        bounds=tuple(k1.coarsen_bounds(b).contiguous() for b in
                     (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds)),
        counts=(scene.spheres.count, scene.triangles.count, n_boxes),
        rectab=_packed_all(scene).contiguous(),
        mattab=mattab.contiguous(),
        texmeta=texmeta.contiguous(),
        atlas_rows=pad1(bank.data.reshape(-1, 3)).contiguous(),
        grad_rows=bank.grad.reshape(-1, 2).contiguous(),
        env_rows=env_rows.contiguous(),
        atlas_hw=(int(bank.data.shape[1]), int(bank.data.shape[2])),
        env_hw=env_hw,
    )


def fused_supported(scene, config, env=None, check_spp: bool = True) -> bool:
    """Whether the fused step covers this render (else sample-chunk it or,
    past the limits below, nothing in the port does yet)."""
    n_tex = int(np.prod(tuple(scene.textures.data.shape[:3])))
    env_texels = 0
    if env is not None and config.env_mode == env_mod.HDR_MAP:
        env_texels = int(np.prod(tuple(env.hdr_image.shape[:2])))
    return (
        scene.mm is not None
        and (not check_spp
             or config.n_pixels * config.samples_per_pixel * 2
             < _TOTAL_WORK_CAP)
        # Atlas and equirect rows travel as f32 between K2 and K3.
        and n_tex < (1 << 24)
        and env_texels < (1 << 24)
    )


def fused_spp_chunk(scene, config, env=None) -> int:
    """Largest per-call spp under the work-id cap (0 = unsupported)."""
    if not fused_supported(scene, config, env, check_spp=False):
        return 0
    return max(0, (_TOTAL_WORK_CAP - 1) // (2 * config.n_pixels))


# ---------------------------------------------------------------------------
# K2: hit-record decode
# ---------------------------------------------------------------------------

def _aparams(env, device) -> torch.Tensor:
    """[tmin, cos/sin yaw, cos/sin tilt, cos/sin roll, 0] (f32 [8])."""
    e = env.to(device)
    return torch.stack([
        torch.tensor(T_MIN, dtype=torch.float32, device=device),
        torch.cos(e.hdri_rotation), torch.sin(e.hdri_rotation),
        torch.cos(e.hdri_tilt), torch.sin(e.hdri_tilt),
        torch.cos(e.hdri_roll), torch.sin(e.hdri_roll),
        torch.zeros((), dtype=torch.float32, device=device)])


def decode_plain(tables: FusedTables, od, t, idx, typ, aparams):
    """Plain PyTorch K2 (reference _decode_kernel): [24, P] f32 rows."""
    o = (od[0], od[1], od[2])
    d = (od[3], od[4], od[5])
    hit = t < T_MAX
    t_safe = torch.where(hit, t, 1.0)
    n_s, n_t, _ = tables.counts
    is_tri = typ == PRIM_TRIANGLE
    is_box = typ == PRIM_BOX
    is_sph = typ == PRIM_SPHERE
    base = torch.where(is_tri, n_s, torch.where(is_box, n_s + n_t, 0))
    row = torch.clamp(idx + base, 0, tables.rectab.shape[0] - 1)
    grow = tables.rectab[row]                                   # [P, 28]

    def sel_cols(mask, default, ncols):
        return tuple(torch.where(mask, grow[:, k], float(default[k]))
                     for k in range(ncols)) + (None,) * (28 - ncols)

    sp = _sphere_record_soa(sel_cols(is_sph, _SPHERE_DEFAULT_ROW, 5), o, d,
                            t_safe)
    tp = _triangle_record_soa(sel_cols(is_tri, _TRI_DEFAULT_ROW, 28), o, d,
                              t_safe)

    def sel(mask, a, b):
        if isinstance(a, tuple):
            return soa.where(mask, b, a)
        return torch.where(mask, b, a)

    parts = tuple(sel(is_tri, sp[i], tp[i]) for i in range(8))
    if tables.counts[2]:
        bp = _box_record_soa(sel_cols(is_box, _BOX_DEFAULT_ROW, 13), o, d,
                             t_safe)
        parts = tuple(sel(is_box, parts[i], bp[i]) for i in range(8))
    p, normal, tangent, bitangent, front, u, v, mat = parts

    mrow = tables.mattab[torch.clamp(mat, 0.0, tables.mattab.shape[0] - 1)
                         .to(torch.int64)]
    solid = (mrow[:, 0], mrow[:, 1], mrow[:, 2])
    param, mtype, tex_id = mrow[:, 3], mrow[:, 4], mrow[:, 5]
    bump_id, bstr = mrow[:, 6], mrow[:, 7]
    kmax = tables.texmeta.shape[0] - 1

    tmeta = tables.texmeta[torch.clamp(tex_id, 0.0, kmax).to(torch.int64)]
    kind, tw, th = tmeta[:, 0], tmeta[:, 1], tmeta[:, 2]
    uu = u - torch.floor(u)
    ti = _clip(torch.floor(uu * tw), torch.clamp(tw - 1.0, min=0.0))
    tj = _clip(torch.floor(v * th), torch.clamp(th - 1.0, min=0.0))
    ah, aw = float(tables.atlas_hw[0]), float(tables.atlas_hw[1])
    texrow = (torch.clamp(tex_id, min=0.0) * ah + tj) * aw + ti
    is_diel = mtype == mat_mod.DIELECTRIC
    is_image = (kind == tex_mod.KIND_IMAGE) & (tex_id >= 0.0) & ~is_diel
    inv_scale = tmeta[:, 3]
    cells = (torch.floor(inv_scale * p[0]) + torch.floor(inv_scale * p[1])
             + torch.floor(inv_scale * p[2]))
    is_even = cells - 2.0 * torch.floor(cells * 0.5) == 0.0
    cyan = (0.0, 1.0, 1.0)
    base_color = []
    for c in range(3):
        col = torch.where(is_even, tmeta[:, 4 + c], tmeta[:, 7 + c])
        col = torch.where(kind == tex_mod.KIND_MISSING, cyan[c], col)
        base_color.append(torch.where((tex_id < 0.0) | is_diel, solid[c], col))

    bmeta = tables.texmeta[torch.clamp(bump_id, 0.0, kmax).to(torch.int64)]
    bw, bh = bmeta[:, 1], bmeta[:, 2]
    bwm = torch.clamp(bw - 1.0, min=0.0)
    bhm = torch.clamp(bh - 1.0, min=0.0)
    buu = u - torch.floor(u)
    bi = _clip(torch.floor(buu * bw), bwm)
    bj = _clip(torch.floor(v * bh), bhm)
    bumprow = (torch.clamp(bump_id, min=0.0) * ah + bj) * aw + bi
    delta = 1.0 / 1024.0
    u2 = u + delta
    uu2 = u2 - torch.floor(u2)
    bi2 = _clip(torch.floor(uu2 * bw), bwm)
    bj2 = _clip(torch.floor((v + delta) * bh), bhm)
    has_bump = bump_id >= 0.0
    gate_u = ((bi2 != bi) & has_bump).to(torch.float32)
    gate_v = ((bj2 != bj) & has_bump).to(torch.float32)

    envrow = torch.zeros_like(t)
    if tables.env_hw is not None:
        ex, ey, ez = soa.normalize(d)
        cy, sy, cp, sp_, cr, sr = (aparams[k] for k in range(1, 7))
        ex, ez = cy * ex + sy * ez, -sy * ex + cy * ez
        ey, ez = cp * ey - sp_ * ez, sp_ * ey + cp * ez
        ex, ey = cr * ex - sr * ey, sr * ex + cr * ey
        phi = vecmath.atan2_poly(ez, ex) + PI
        theta = vecmath.acos_poly(ey)
        eh, ew = float(tables.env_hw[0]), float(tables.env_hw[1])
        euu = phi / phi.new_tensor(2.0 * PI)
        euu = euu - torch.floor(euu)
        ei = _clip(torch.floor(euu * ew), ew - 1.0)
        ej = _clip(torch.floor(theta / theta.new_tensor(PI) * eh), eh - 1.0)
        envrow = ej * ew + ei

    rows = (hit.to(torch.float32), t,
            normal[0], normal[1], normal[2],
            tangent[0], tangent[1], tangent[2],
            bitangent[0], bitangent[1], bitangent[2],
            front.to(torch.float32), mtype, param, bstr,
            base_color[0], base_color[1], base_color[2],
            gate_u, gate_v, has_bump.to(torch.float32),
            torch.where(is_image, texrow, -1.0),
            torch.where(has_bump, bumprow, 0.0),
            envrow)
    return torch.stack(rows, dim=0)


def _clip(x, hi):
    """clip(x, 0, hi) with hi >= 0 (a tensor or a float)."""
    return torch.minimum(torch.clamp(x, min=0.0), torch.as_tensor(hi, device=x.device))


def decode(tables: FusedTables, od, t, idx, typ, aparams):
    """K2: hit-record decode of the closest hits. od f32[6, P]; t, idx,
    typ from K1. Returns f32[24, P] (_RO_* rows). CPU tensors take
    `decode_plain`; CUDA tensors launch csrc/decode.cu."""
    if od.device.type == "cpu":
        return decode_plain(tables, od, t, idx, typ, aparams)
    kernels.require_cuda(od, t, aparams, tables.rectab, tables.mattab,
                         tables.texmeta, dtype=torch.float32)
    kernels.require_cuda(idx, typ, dtype=torch.int32)
    p = od.shape[1]
    out = torch.empty((_RO_ROWS, p), dtype=torch.float32, device=od.device)
    eh, ew = tables.env_hw if tables.env_hw is not None else (0, 0)
    kernels.launch(
        "decode_launch", od, t, idx, typ, p, aparams,
        tables.rectab, tables.rectab.shape[0], tables.mattab,
        tables.mattab.shape[0], tables.texmeta, tables.texmeta.shape[0],
        tables.counts[0], tables.counts[1], 1 if tables.counts[2] else 0,
        float(tables.atlas_hw[0]), float(tables.atlas_hw[1]),
        1 if tables.env_hw is not None else 0, float(eh), float(ew), out)
    decode.launches += 1
    return out


decode.launches = 0


def trace_decode(tables: FusedTables, od, aparams):
    """K1 then K2 on the pool's rays: the [24, P] hit-record rows."""
    t, idx, typ = k1.closest_hit(od, T_MIN, tables.coeffs, tables.bounds,
                                 tables.counts)
    return decode(tables, od, t, idx, typ, aparams)


# ---------------------------------------------------------------------------
# K3: shade, advance, respawn
# ---------------------------------------------------------------------------

class StepParams(NamedTuple):
    """Scalars of one pool render, shared by every K3 launch."""

    seed: int            # u32
    sample_offset: int
    n_pixels: int
    width: int
    total_work: int
    max_depth: int
    env_mode: int


def _bparams(cam, env, device) -> torch.Tensor:
    """Camera and environment parameters of K3 (f32 [40], _BP_* layout)."""
    c, e = cam.to(device), env.to(device)
    sun_dir = vecmath.normalize(e.sun_direction)
    return torch.cat([
        c.center, c.pixel00, c.pixel_delta_u, c.pixel_delta_v,
        c.defocus_disk_u, c.defocus_disk_v, sun_dir, e.sun_color,
        e.sun_intensity[None], e.sun_size[None], e.intensity[None],
        e.background_color, c.u, c.v, c.w,
        torch.zeros((1,), dtype=torch.float32, device=device)]).contiguous()


def _sun_sky(bp, ux, uy, uz):
    """Procedural sun-sky radiance (camera.hpp:871-925)."""
    sdx, sdy, sdz = bp[_BP_SUN_DIR], bp[_BP_SUN_DIR + 1], bp[_BP_SUN_DIR + 2]
    sun_height = sdy
    adjusted = sun_height - 0.05
    sky_exposure = torch.clamp(adjusted * 8.0 + 1.4, 0.0, 1.0)
    day_factor = torch.clamp(adjusted * 10.0 + 1.1, 0.0, 1.0)
    sunset_i = torch.clamp(1.0 - torch.abs(adjusted + 0.05) * 30.0, 0.0, 1.0)
    sunset = torch.where(adjusted > -0.1, sunset_i, 0.0)
    sunset = torch.where(sun_height < 0.0, sunset * (sun_height * 10.0 + 1.0),
                         sunset)
    sunset = torch.clamp(sunset, 0.0, 1.0)
    zen = [0.01, 0.03, 0.1]
    zday = [0.2, 0.5, 1.0]
    hor = [0.05, 0.02, 0.01]
    hday = [0.6, 0.8, 1.0]
    hsun = [1.0, 0.35, 0.1]
    scol_sunset = [1.0, 0.3, 0.1]
    visibility = torch.clamp(sun_height * 5.0 + 1.0, 0.0, 1.0)
    threshold = 1.0 - bp[_BP_SUN_SIZE] * 0.001
    sun_focus = ux * sdx + uy * sdy + uz * sdz
    alpha = vecmath.smoothstep(threshold, threshold + 0.0002, sun_focus)
    disc_on = (sun_focus > threshold) & (adjusted > -0.1)
    up = uy > 0.0
    gain = bp[_BP_INTENSITY] * 1.5 * sky_exposure
    out = []
    for k in range(3):
        zenith = zen[k] * (1.0 - day_factor) + zday[k] * day_factor
        horizon = hor[k] * (1.0 - day_factor) + hday[k] * day_factor
        horizon = horizon * (1.0 - sunset) + hsun[k] * sunset
        sky = torch.where(up, (1.0 - uy) * horizon + uy * zenith, horizon * 0.1)
        s_col = bp[_BP_SUN_COL + k] * (1.0 - sunset) + scol_sunset[k] * sunset
        disc = torch.where(disc_on,
                           s_col * bp[_BP_SUN_INT] * visibility * alpha, 0.0)
        out.append(sky * gain + disc)
    return tuple(out)


def _raygen(bp, seed, pix, samp, width: int):
    """Camera rays of respawned lanes (camera.hpp:784-794): the same draws
    and arithmetic as camera.generate_rays_soa, parameters from bp."""
    lr0 = rng.LaneRng(seed, rng.u32(pix), rng.u32(samp), 0)
    (off_x, off_y), (r0, r1) = rng.draw_camera(lr0)
    ii, jj = camera_mod.pixel_rowcol_f32(pix, width)
    px = ii + off_x
    py = jj + off_y
    o = tuple(bp[_BP_CENTER + k] + r0 * bp[_BP_DDU + k] + r1 * bp[_BP_DDV + k]
              for k in range(3))
    d = tuple(bp[_BP_P00 + k] + px * bp[_BP_DU + k] + py * bp[_BP_DV + k]
              - o[k] for k in range(3))
    return o, d


def shade_advance_plain(tables: FusedTables, rec, state_f, state_i,
                        next_work, segments, bparams, sp: StepParams):
    """Plain PyTorch K3 (reference _shade_advance_kernel, beauty only).

    rec f32[24, P]; state_f f32[12, P] (o, d, throughput, radiance);
    state_i i32[4, P] (live, bounce, sample, pixel); next_work i32[1];
    segments i64[1]. Returns (state_f, state_i, contrib f32[3, P],
    tgt i32[P], next_work i32[1], segments i64[1], live_count i32[1])."""
    bp = bparams
    hit = rec[_RO_HIT] > 0.5
    t_hit = rec[_RO_T]
    normal = (rec[_RO_N], rec[_RO_N + 1], rec[_RO_N + 2])
    tangent = (rec[_RO_TAN], rec[_RO_TAN + 1], rec[_RO_TAN + 2])
    bitangent = (rec[_RO_BIT], rec[_RO_BIT + 1], rec[_RO_BIT + 2])
    front = rec[_RO_FRONT] > 0.5
    mtype, param, bstr = rec[_RO_MTYPE], rec[_RO_PARAM], rec[_RO_BSTR]
    base_col = (rec[_RO_BASE], rec[_RO_BASE + 1], rec[_RO_BASE + 2])
    gate_u, gate_v = rec[_RO_GU], rec[_RO_GV]

    # The texel, bump-delta and HDR row gathers (direct loads in the kernel).
    tex4 = tables.atlas_rows[torch.clamp(rec[_RO_TEXROW], min=0.0).to(torch.int64)]
    gb2 = tables.grad_rows[torch.clamp(rec[_RO_BUMPROW], min=0.0).to(torch.int64)]
    is_image_lane = rec[_RO_TEXROW] >= -0.5
    tex3 = tuple(torch.where(is_image_lane, tex4[:, k], base_col[k])
                 for k in range(3))

    o = (state_f[0], state_f[1], state_f[2])
    d = (state_f[3], state_f[4], state_f[5])
    thr = (state_f[6], state_f[7], state_f[8])
    rad = (state_f[9], state_f[10], state_f[11])
    live = state_i[0] > 0
    bounce, samp, li = state_i[1], state_i[2], state_i[3]
    lr = rng.LaneRng(sp.seed, rng.u32(li), rng.u32(samp), rng.u32(bounce) << 1)

    t_safe = torch.where(hit, t_hit, 1.0)
    hp = tuple(t_safe * d[k] + o[k] for k in range(3))

    ud = soa.normalize(d)
    if sp.env_mode == env_mod.PHYSICAL_SUN:
        bg = _sun_sky(bp, *ud)
    elif sp.env_mode == env_mod.SOLID_COLOR:
        one = torch.ones_like(t_hit)
        bg = tuple(bp[_BP_BG + k] * bp[_BP_INTENSITY] * one for k in range(3))
    else:
        env4 = tables.env_rows[rec[_RO_ENVROW].to(torch.int64)]
        bg = tuple(env4[:, k] * bp[_BP_INTENSITY] for k in range(3))

    sphere_draw, choice_u = rng.draw_unit_vector_and_uniform_soa(
        lr, rng.STREAM_SCATTER)
    f_u = gb2[:, 0] * gate_u * bstr
    f_v = gb2[:, 1] * gate_v * bstr
    n_b = tuple(normal[k] - f_u * tangent[k] - f_v * bitangent[k]
                for k in range(3))
    has_bump = rec[_RO_HASB] > 0.5
    working_n = soa.where(has_bump, soa.normalize(n_b), normal)
    unit_in = soa.normalize(d)

    lam_dir = soa.add(working_n, sphere_draw)
    lam_dir = soa.where(soa.near_zero(lam_dir), working_n, lam_dir)
    eps_origin = soa.axpy(RAY_EPSILON, normal, hp)

    reflected = soa.reflect(unit_in, working_n)
    metal_dir = soa.normalize(soa.axpy(param, sphere_draw, reflected))
    metal_ok = soa.dot(metal_dir, normal) > 0.0

    ri = torch.where(front, 1.0 / torch.clamp(param, min=1e-6), param)
    cos_theta = torch.clamp(soa.dot(soa.neg(unit_in), working_n), max=1.0)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ri * sin_theta > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0s = r0 * r0
    c1 = 1.0 - cos_theta
    c2 = c1 * c1
    reflect_prob = r0s + (1.0 - r0s) * (c1 * (c2 * c2))
    do_reflect = cannot_refract | (reflect_prob > choice_u)
    refracted = soa.refract(unit_in, working_n, ri)
    diel_dir = soa.where(do_reflect, reflected, refracted)
    offset_out = soa.dot(diel_dir, normal) > 0.0
    diel_origin = soa.axpy(
        torch.where(offset_out, RAY_EPSILON, -RAY_EPSILON), normal, hp)

    is_lam = mtype == mat_mod.LAMBERTIAN
    is_metal = mtype == mat_mod.METAL
    is_diel = mtype == mat_mod.DIELECTRIC
    is_iso = mtype == mat_mod.ISOTROPIC
    is_emit = mtype == mat_mod.EMISSIVE

    sc_dir = soa.where(is_lam, lam_dir,
             soa.where(is_metal, metal_dir,
             soa.where(is_diel, diel_dir, sphere_draw)))
    sc_origin = soa.where(is_lam | is_metal, eps_origin,
                soa.where(is_diel, diel_origin, hp))
    attenuation = tex3
    scattered = is_lam | (is_metal & metal_ok) | is_diel | is_iso
    zero = torch.zeros_like(t_hit)
    emitted = soa.where(is_emit, tex3, (zero, zero, zero))

    # Radiance / path update, in the reference's wavefront order.
    miss = live & ~hit
    rad = tuple(rad[k] + torch.where(miss, thr[k] * bg[k], 0.0)
                for k in range(3))
    active = live & hit
    rad = tuple(rad[k] + torch.where(active, thr[k] * emitted[k], 0.0)
                for k in range(3))
    gainm = active & scattered
    thr = soa.where(gainm, soa.mul(thr, attenuation), thr)
    active = active & scattered

    late = (bounce - 1) > RR_START_BOUNCE
    weak = late & (soa.length(thr) < WEAK_RAY_EPS)
    active = active & ~weak
    p_rr = torch.clamp(torch.maximum(thr[0], torch.maximum(thr[1], thr[2])),
                       RR_P_MIN, RR_P_MAX)
    u_rr = rng.draw_uniform(lr, rng.STREAM_RR)
    active = active & ~(late & (u_rr > p_rr))
    thr = soa.where(late & active, soa.scale(thr, 1.0 / p_rr), thr)
    active = active & (bounce + 1 < sp.max_depth)

    done = live & ~active
    tgt = torch.where(done, li, sp.n_pixels).to(torch.int32)
    contrib = torch.stack([torch.where(done, rad[k], 0.0) for k in range(3)])

    # Respawn: lane -> work id = next_work + inclusive prefix count of
    # free lanes (lane order) - 1, spawning while below total_work.
    free = ~live | done
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    new_w = next_work.to(torch.int64) + rank
    can_spawn = free & (new_w < sp.total_work)
    w = torch.clamp(new_w, 0, sp.total_work - 1)
    wf = w.to(torch.float32)
    n = sp.n_pixels
    sr = torch.floor((wf + 0.5) * (1.0 / n))
    sli = wf - sr * n
    sr = torch.where(sli < 0.0, sr - 1.0, torch.where(sli >= n, sr + 1.0, sr))
    sli = wf - sr * n
    new_li = sli.to(torch.int32)
    new_samp = sp.sample_offset + sr.to(torch.int32)
    so, sd = _raygen(bp, sp.seed, new_li, new_samp, sp.width)

    sel = lambda fresh, old: torch.where(can_spawn, fresh, old)
    one = torch.ones_like(t_hit)
    n_live = (live & active) | can_spawn
    state_f = torch.stack([
        sel(so[0], torch.where(active, sc_origin[0], o[0])),
        sel(so[1], torch.where(active, sc_origin[1], o[1])),
        sel(so[2], torch.where(active, sc_origin[2], o[2])),
        sel(sd[0], torch.where(active, sc_dir[0], d[0])),
        sel(sd[1], torch.where(active, sc_dir[1], d[1])),
        sel(sd[2], torch.where(active, sc_dir[2], d[2])),
        sel(one, thr[0]), sel(one, thr[1]), sel(one, thr[2]),
        sel(zero, rad[0]), sel(zero, rad[1]), sel(zero, rad[2])])
    state_i = torch.stack([
        n_live.to(torch.int32),
        torch.where(can_spawn, 0, bounce + 1).to(torch.int32),
        sel(new_samp, samp).to(torch.int32),
        sel(new_li, li).to(torch.int32)])
    total_free = free.sum()
    next_out = torch.clamp(next_work.to(torch.int64) + total_free,
                           max=sp.total_work).to(torch.int32).reshape(1)
    seg_out = (segments + live.sum()).reshape(1)
    live_count = n_live.sum().to(torch.int32).reshape(1)
    return state_f, state_i, contrib, tgt, next_out, seg_out, live_count


def shade_advance(tables: FusedTables, rec, state_f, state_i, next_work,
                  segments, bparams, sp: StepParams):
    """K3: shade every lane, advance its path, and respawn finished lanes
    from the work counter. CPU tensors take `shade_advance_plain`; CUDA
    tensors launch csrc/shade_advance.cu. Same signature and results."""
    if rec.device.type == "cpu":
        return shade_advance_plain(tables, rec, state_f, state_i, next_work,
                                   segments, bparams, sp)
    kernels.require_cuda(rec, state_f, bparams, tables.atlas_rows,
                         tables.grad_rows, tables.env_rows, dtype=torch.float32)
    kernels.require_cuda(state_i, next_work, dtype=torch.int32)
    kernels.require_cuda(segments, dtype=torch.int64)
    p = rec.shape[1]
    dev = rec.device
    block = 256
    n_blocks = -(-p // block)
    out_f = torch.empty_like(state_f)
    out_i = torch.empty_like(state_i)
    contrib = torch.empty((3, p), dtype=torch.float32, device=dev)
    tgt = torch.empty((p,), dtype=torch.int32, device=dev)
    counts = torch.empty((3, n_blocks), dtype=torch.int32, device=dev)
    next_out = torch.empty((1,), dtype=torch.int32, device=dev)
    seg_out = torch.empty((1,), dtype=torch.int64, device=dev)
    live_count = torch.empty((1,), dtype=torch.int32, device=dev)
    kernels.launch(
        "shade_advance_launch", rec, state_f, state_i, p, bparams,
        tables.atlas_rows, tables.grad_rows, tables.env_rows, sp.seed,
        sp.sample_offset, sp.n_pixels, float(np.float32(1.0 / sp.n_pixels)),
        sp.width, float(np.float32(1.0 / sp.width)), sp.total_work,
        sp.max_depth, sp.env_mode, next_work, segments, out_f, out_i,
        contrib, tgt, counts, next_out, seg_out, live_count)
    shade_advance.launches += 1
    return out_f, out_i, contrib, tgt, next_out, seg_out, live_count


shade_advance.launches = 0


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------

def pool_size(config, total_work: int) -> int:
    """Lanes of the pool. A pool smaller than the work is rounded up to a
    multiple of the reference's kernel-B block (4096 lanes), which keeps
    the lane -> work mapping of the reference; a pool that holds all the
    work never respawns, so it is cut to the work itself."""
    p = config.pool_lanes or DEFAULT_POOL_LANES
    p = -(-p // B_BLOCK) * B_BLOCK
    return min(p, total_work)


def _host_copy(x: torch.Tensor):
    """(event, host tensor): x copied to the host. On the card the copy goes
    to pinned memory without a sync; the host tensor is valid once the
    event has completed. On the CPU the event is None."""
    if x.device.type == "cpu":
        return None, x.clone()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return ev, host


def render_pool_fused(scene, cam, env, seed: int, config, sample_offset=0,
                      with_stats: bool = False):
    """Beauty sums f32[n_pixels, 3] of `config.samples_per_pixel` samples
    from `sample_offset` on, through the fused pool on the scene's device.
    with_stats also returns {"segments", "steps"}: path segments traced
    (int64 on the device, exact) and steps taken with live lanes."""
    dev = scene.spheres.center.device
    n = config.n_pixels
    spp = config.samples_per_pixel
    total_work = n * spp
    p = pool_size(config, total_work)
    tables = build_tables(scene, env, config.env_mode)
    aparams = _aparams(env, dev)
    bparams = _bparams(cam, env, dev)
    sp = StepParams(seed=rng.seed_from_int(seed), sample_offset=int(sample_offset),
                    n_pixels=n, width=config.width, total_work=total_work,
                    max_depth=config.max_depth, env_mode=config.env_mode)

    # Initial fill: the same (pixel, sample) decode as the respawn.
    w0 = torch.arange(p, dtype=torch.int64, device=dev)
    wc = torch.clamp(w0, max=total_work - 1)
    samp_rel = wc // n
    li0 = (wc - samp_rel * n).to(torch.int32)
    samp0 = (sample_offset + samp_rel).to(torch.int32)
    lr0 = rng.LaneRng(sp.seed, rng.u32(li0), rng.u32(samp0), 0)
    o0, d0 = camera_mod.generate_rays_soa(cam.to(dev), lr0, li0, config.width)
    live0 = (w0 < total_work).to(torch.int32)
    ones = torch.ones((p,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((p,), dtype=torch.float32, device=dev)
    state_f = torch.stack([*o0, *d0, ones, ones, ones, zeros, zeros, zeros])
    state_i = torch.stack([live0, torch.zeros_like(live0), samp0, li0])
    next_work = torch.full((1,), min(p, total_work), dtype=torch.int32,
                           device=dev)
    live_count = live0.sum().to(torch.int32).reshape(1)
    segments = torch.zeros((1,), dtype=torch.int64, device=dev)
    steps = torch.zeros((1,), dtype=torch.int64, device=dev)
    stride = n + 1
    acc = torch.zeros((3 * stride,), dtype=torch.float32, device=dev)

    lag = 1 if dev.type == "cpu" else LIVE_LAG
    pending = collections.deque([_host_copy(live_count)])
    while True:
        if len(pending) >= lag:
            ev, live_host = pending.popleft()
            if ev is not None:
                ev.synchronize()
            if int(live_host[0]) == 0:
                break
        # Steps after the pool drains are no-ops: nothing is live, nothing
        # spawns, and every target is the dummy slot n.
        steps += (live_count > 0).to(torch.int64)
        rec = trace_decode(tables, state_f[:6], aparams)
        (state_f, state_i, contrib, tgt, next_work, segments,
         live_count) = shade_advance(tables, rec, state_f, state_i, next_work,
                                     segments, bparams, sp)
        tgt64 = tgt.to(torch.int64)
        acc.index_add_(0, torch.cat([tgt64, tgt64 + stride, tgt64 + 2 * stride]),
                       contrib.reshape(-1))
        pending.append(_host_copy(live_count))
    beauty = torch.stack([acc[k * stride:k * stride + n] for k in range(3)],
                         dim=-1)
    if with_stats:
        return beauty, {"segments": int(segments.item()),
                        "steps": int(steps.item())}
    return beauty
