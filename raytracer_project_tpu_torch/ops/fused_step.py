"""The fused pooled-wavefront step (twin of
raytracer_project_tpu/ops/fused_step.py).

A pool of P lanes traces one path segment per step. Each step is two
kernels:

  K1 closest hit    ops/closest_hit.py          (csrc/closest_hit.cu)
  K3 fused          `shade_accumulate` below    (csrc/shade_advance.cu)

K3 fused decodes K1's hits in registers (K2's work, csrc/decode.cuh),
shades and advances every lane, adds what each lane finishes straight
into the flat accumulator, and respawns free lanes (a second launch);
the pool then copies the live count to the host. The reference's split
into K2 decode, K3 shade-advance and one wide scatter of every channel
stays as `decode` and `shade_advance` (contribution and target rows):
the kernel probe P3 runs K2, the card's checks time K2 + K3 as K3
fused's yardstick, and `shade_accumulate_plain` is that composition,
with the scatter, on the CPU.

Besides beauty, K3 samples solid-albedo fog, writes the albedo / normal /
z-depth AOVs of camera segments, and runs the reflection/refraction split
passes as spec lanes: work ids n*spp .. 2*n*spp-1 retrace each sample's
camera ray with RNG context (bounce << 1) | 1 and add to the pass its
first hit routes them to. Which of these a render needs selects K3's
compiled variant.

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
import contextlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core import rng, soa, vecmath
from ..core.constants import (
    PI, RAY_EPSILON, RR_P_MAX, RR_P_MIN, RR_START_BOUNCE, T_MAX, T_MIN,
    WEAK_RAY_EPS, Z_DEPTH_MAX_DIST,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models import materials as mat_mod
from ..models import textures as tex_mod
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from ..utils import spans
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
_BP_CAM_U = 30   # camera right, up, backward (the view-space normal AOV)
_BP_CAM_V = 33
_BP_CAM_W = 36

# K3 volume rows (f32 [V, 16]; fused_step.py:1266-1281 of the reference).
_VP_KIND = 0     # 0 sphere, 1 box
_VP_CENTER = 1   # 1:4
_VP_RADIUS = 4
_VP_BMIN = 5     # 5:8
_VP_BMAX = 8     # 8:11
_VP_NID = 11     # -1/density
_VP_ALBEDO = 12  # 12:15 the phase material's solid albedo
_VP_COLS = 16

# Work-id cap: respawn decodes (pixel, sample) from the work id in f32,
# exact only below 2^24; larger renders are sample-chunked.
_TOTAL_WORK_CAP = 1 << 24


class FusedTables(NamedTuple):
    """Scene constants read by the kernels: plain f32 row-major tables."""

    scan: k1.ScanTables  # K1's tables (dense, compact rows, tile AABBs,
                         # counts)
    rectab: torch.Tensor     # f32[Ntot, 28] packed primitive shading rows
    mattab: torch.Tensor     # f32[M, 8] albedo rgb, param, mtype, tex, bump, bstr
    texmeta: torch.Tensor    # f32[K, 10] kind, w, h, inv_scale, even rgb, odd rgb
    atlas_rows: torch.Tensor  # f32[K*AH*AW, 4] texels (r, g, b, 0)
    grad_rows: torch.Tensor   # f32[K*AH*AW, 2] bump neighbour deltas
    env_rows: torch.Tensor    # f32[EH*EW, 4] HDR texels (zeros [1, 4] unless HDR)
    vparams: torch.Tensor     # f32[V, 16] fog volumes (_VP_*; zeros [1, 16] if none)
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
    scan = k1.scan_tables(scene)
    vparams = torch.zeros((1, _VP_COLS), dtype=torch.float32,
                          device=mattab.device)
    vol = scene.volumes
    if vol is not None and vol.count:
        if vol.textured is not None:
            raise NotImplementedError(
                "the fused pool samples solid-albedo fog only; "
                "wavefront.render_pool routes textured fog to the unfused "
                "pool (wavefront.render_unfused)")
        col = lambda x: x.to(torch.float32).reshape(vol.count, -1)
        vparams = torch.cat([
            col(vol.kind), col(vol.center), col(vol.radius), col(vol.box_min),
            col(vol.box_max), col(vol.neg_inv_density),
            m.albedo[vol.mat.long()],
            torch.zeros((vol.count, 1), dtype=torch.float32,
                        device=mattab.device)], dim=1)
    return FusedTables(
        scan=scan,
        rectab=_packed_all(scene).contiguous(),
        mattab=mattab.contiguous(),
        texmeta=texmeta.contiguous(),
        atlas_rows=pad1(bank.data.reshape(-1, 3)).contiguous(),
        grad_rows=bank.grad.reshape(-1, 2).contiguous(),
        env_rows=env_rows.contiguous(),
        vparams=vparams.contiguous(),
        atlas_hw=(int(bank.data.shape[1]), int(bank.data.shape[2])),
        env_hw=env_hw,
    )


def fused_supported(scene, config, env=None, check_spp: bool = True) -> bool:
    """Whether the fused step covers this render (else sample-chunk it or,
    past the limits below, take the unfused pool). Fog is sampled in
    K3 with the volume's albedo resolved ahead, which needs solid
    (untextured) phase materials, the only kind the builder makes by
    default; `build_tables` raises on textured fog."""
    n_tex = int(np.prod(tuple(scene.textures.data.shape[:3])))
    env_texels = 0
    if env is not None and config.env_mode == env_mod.HDR_MAP:
        env_texels = int(np.prod(tuple(env.hdr_image.shape[:2])))
    volumes_ok = scene.volumes is None or scene.volumes.textured is None
    return (
        scene.mm is not None
        and volumes_ok
        and (not check_spp
             or config.n_pixels * config.samples_per_pixel * 2
             < _TOTAL_WORK_CAP)
        # Atlas and equirect rows travel as f32 between K2 and K3.
        and n_tex < (1 << 24)
        and env_texels < (1 << 24)
    )


def fused_spp_chunk(scene, config, env=None,
                    n_pixels_local: int | None = None) -> int:
    """Largest per-call spp under the work-id cap (0 = unsupported). The
    cap applies to the pixel window of n_pixels_local pixels when given."""
    if not fused_supported(scene, config, env, check_spp=False):
        return 0
    n = n_pixels_local if n_pixels_local is not None else config.n_pixels
    return max(0, (_TOTAL_WORK_CAP - 1) // (2 * n))


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


def decode_records_plain(tables: FusedTables, od, t, idx, typ):
    """The first part of K2's plain version: the packed primitive row of
    each closest hit (f32 [P, 28]) and the shading record decoded from it,
    (p, normal, tangent, bitangent, front, u, v, mat)."""
    o = (od[0], od[1], od[2])
    d = (od[3], od[4], od[5])
    t_safe = torch.where(t < T_MAX, t, 1.0)
    n_s, n_t, _ = tables.scan.counts
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
    if tables.scan.counts[2]:
        bp = _box_record_soa(sel_cols(is_box, _BOX_DEFAULT_ROW, 13), o, d,
                             t_safe)
        parts = tuple(sel(is_box, parts[i], bp[i]) for i in range(8))
    return grow, parts


def decode_plain(tables: FusedTables, od, t, idx, typ, aparams):
    """Plain PyTorch K2 (reference _decode_kernel): [24, P] f32 rows."""
    d = (od[3], od[4], od[5])
    hit = t < T_MAX
    _, parts = decode_records_plain(tables, od, t, idx, typ)
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
        tables.scan.counts[0], tables.scan.counts[1],
        1 if tables.scan.counts[2] else 0,
        float(tables.atlas_hw[0]), float(tables.atlas_hw[1]),
        1 if tables.env_hw is not None else 0, float(eh), float(ew), out)
    kernels.count(decode)
    return out


decode.launches = 0


def trace_decode(tables: FusedTables, od, aparams):
    """K1 then K2 on the rays od: the [24, P] hit-record rows."""
    t, idx, typ = k1.closest_hit(od, T_MIN, tables.scan)
    return decode(tables, od, t, idx, typ, aparams)


# ---------------------------------------------------------------------------
# K3: shade, advance, respawn
# ---------------------------------------------------------------------------

class StepParams(NamedTuple):
    """Scalars of one pool render, shared by every K3 launch. The fields
    from `aux` on select K3's variant (reference _shade_advance_kernel's
    static arguments); their defaults give the beauty variant."""

    seed: int            # u32
    sample_offset: int
    n_pixels: int        # the pixel window's size (the frame's by default)
    width: int
    total_work: int
    max_depth: int
    env_mode: int
    aux: int = 0                 # AOV samples: absolute sample ids below it
    z_max: float = Z_DEPTH_MAX_DIST
    aovs: tuple = ()             # subset of AOVS, in that order
    use_reflection: bool = False
    use_refraction: bool = False
    n_beauty: int = 0            # work ids from here on are spec lanes
    n_volumes: int = 0           # rows of FusedTables.vparams sampled
    pixel_offset: int = 0        # global id of the window's first pixel

    @property
    def want_spec(self) -> bool:
        """Whether the pool runs spec lanes (either split pass is on)."""
        return self.use_reflection or self.use_refraction

    @property
    def features(self) -> bool:
        """Whether this is a variant other than beauty."""
        return bool(self.aovs or self.want_spec or self.n_volumes)


AOVS = ("albedo", "normal", "z_depth")


def _n_aov(aovs: tuple) -> int:
    return 3 * ("albedo" in aovs) + 3 * ("normal" in aovs) + ("z_depth" in aovs)


def state_rows(sp: StepParams) -> tuple:
    """(f32 rows, i32 rows) of the pool state: o, d, throughput, radiance
    and live, bounce, sample, pixel; spec lanes add the first-hit
    attenuation attn0 (f32 x 3) and is_spec, to_refl, to_refr (i32)."""
    return (15, 7) if sp.want_spec else (12, 4)


def acc_channels(sp: StepParams) -> tuple:
    """For each accumulator channel, in the reference's order (beauty rgb,
    3 per enabled AOV with z-depth broadcast, reflection rgb, refraction
    rgb; fused_step.py:1398-1420): (contrib row, tgt row) of K3's outputs.

    contrib rows: beauty 3, then the AOV values (albedo 3, normal 3, z 1 as
    enabled), then reflection 3 and refraction 3 with want_spec. tgt rows:
    beauty, then the AOV target with AOVs, then reflection and refraction
    targets with want_spec."""
    out = [(k, 0) for k in range(3)]
    row, trow = 3, 1
    if sp.aovs:
        for name in AOVS:
            if name in sp.aovs:
                chans = 1 if name == "z_depth" else 3
                out += [(row + min(k, chans - 1), trow) for k in range(3)]
                row += chans
        trow += 1
    if sp.want_spec:
        out += [(row + k, trow) for k in range(3)]
        out += [(row + 3 + k, trow + 1) for k in range(3)]
    return tuple(out)


def output_rows(sp: StepParams) -> tuple:
    """(contrib rows, tgt rows) of K3's outputs (see acc_channels)."""
    return (3 + _n_aov(sp.aovs) + 6 * sp.want_spec,
            1 + bool(sp.aovs) + 2 * sp.want_spec)


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
    """Plain PyTorch K3 (reference _shade_advance_kernel).

    rec f32[24, P]; state_f f32[12 or 15, P] and state_i i32[4 or 7, P]
    (state_rows); next_work i32[1]; segments i64[1]. Returns (state_f,
    state_i, contrib f32[C, P], tgt i32[T, P], next_work i32[1], segments
    i64[1], live_count i32[1]); output_rows gives C and T, acc_channels
    their meaning. Lane pixel ids are global; a target is the lane's slot
    in the window, li - pixel_offset, or n_pixels, the accumulator's dummy
    slot."""
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
    zero = torch.zeros_like(t_hit)
    one = torch.ones_like(t_hit)
    if sp.want_spec:
        is_spec = state_i[4] > 0
        to_refl, to_refr = state_i[5] > 0, state_i[6] > 0
        attn0 = (state_f[12], state_f[13], state_f[14])
        spec_bit = rng.u32(state_i[4])
    else:
        is_spec = torch.zeros_like(live)
        spec_bit = 0
    lr = rng.LaneRng(sp.seed, rng.u32(li), rng.u32(samp),
                     (rng.u32(bounce) << 1) | spec_bit)

    # Participating media (fused_step.py:772-845): per volume, the
    # boundary span clamped by the surface hit, an exponential free
    # flight, and at a scatter the volume's solid-albedo ISOTROPIC phase
    # material with the arbitrary frame (1, 0, 0), front.
    if sp.n_volumes:
        best_vt = torch.where(hit, t_hit, T_MAX)
        vol_take = torch.zeros_like(hit)
        valb = (zero, zero, zero)
        dd_v = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ray_len = vecmath.sqrt(dd_v)
        for v in range(sp.n_volumes):
            vp = tables.vparams[v]
            kind, radius, nid = vp[_VP_KIND], vp[_VP_RADIUS], vp[_VP_NID]
            oc = tuple(vp[_VP_CENTER + k] - o[k] for k in range(3))
            h_v = d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2]
            c_v = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
                   - radius * radius)
            disc = h_v * h_v - dd_v * c_v
            sq = vecmath.sqrt(torch.clamp(disc, min=0.0))
            s_entry = (h_v - sq) / dd_v
            s_exit = (h_v + sq) / dd_v
            s_hit = (disc > 0.0) & (radius > 0.0)
            inv = tuple(1.0 / torch.where(torch.abs(d[k]) < 1e-20,
                                          torch.where(d[k] < 0, -1e-20, 1e-20),
                                          d[k]) for k in range(3))
            t0v = tuple((vp[_VP_BMIN + k] - o[k]) * inv[k] for k in range(3))
            t1v = tuple((vp[_VP_BMAX + k] - o[k]) * inv[k] for k in range(3))
            b_entry = torch.maximum(
                torch.maximum(torch.minimum(t0v[0], t1v[0]),
                              torch.minimum(t0v[1], t1v[1])),
                torch.minimum(t0v[2], t1v[2]))
            b_exit = torch.minimum(
                torch.minimum(torch.maximum(t0v[0], t1v[0]),
                              torch.maximum(t0v[1], t1v[1])),
                torch.maximum(t0v[2], t1v[2]))
            is_sphere = kind < 0.5
            entry = torch.where(is_sphere, s_entry, b_entry)
            exit_ = torch.where(is_sphere, s_exit, b_exit)
            bhit = torch.where(is_sphere, s_hit, b_entry < b_exit)
            e_v = torch.clamp(entry, min=T_MIN)
            x_v = torch.minimum(exit_, best_vt)
            valid = bhit & (e_v < x_v)
            u_v = rng.draw_uniform(lr, rng.STREAM_VOLUME, salt=v + 1)
            flight = nid * torch.log(torch.clamp(u_v, min=1e-38))
            scatters = valid & (flight <= (x_v - e_v) * ray_len)
            t_v = e_v + flight / torch.clamp(ray_len, min=1e-20)
            take = scatters & (t_v < best_vt)
            best_vt = torch.where(take, t_v, best_vt)
            valb = tuple(torch.where(take, vp[_VP_ALBEDO + k], valb[k])
                         for k in range(3))
            vol_take = vol_take | take
        hit = hit | vol_take
        t_hit = torch.where(vol_take, best_vt, t_hit)
        mtype = torch.where(vol_take, float(mat_mod.ISOTROPIC), mtype)
        tex3 = soa.where(vol_take, valb, tex3)
        normal = soa.where(vol_take, (one, zero, zero), normal)
        front = front | vol_take

    t_safe = torch.where(hit, t_hit, 1.0)
    hp = tuple(t_safe * d[k] + o[k] for k in range(3))

    ud = soa.normalize(d)
    if sp.env_mode == env_mod.PHYSICAL_SUN:
        bg = _sun_sky(bp, *ud)
    elif sp.env_mode == env_mod.SOLID_COLOR:
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
    emitted = soa.where(is_emit, tex3, (zero, zero, zero))

    # Radiance / path update, in the reference's wavefront order. A spec
    # lane skips the first hit's emission and attenuation: its trace
    # starts after the first scatter with throughput 1 (camera.hpp:494-498).
    at0 = bounce == 0
    emit_ok = ~(at0 & is_spec)
    miss = live & ~hit
    rad = tuple(rad[k] + torch.where(miss, thr[k] * bg[k], 0.0)
                for k in range(3))
    active = live & hit
    rad = tuple(rad[k] + torch.where(active & emit_ok, thr[k] * emitted[k], 0.0)
                for k in range(3))
    gainm = active & scattered & emit_ok
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

    # Spec-pass routing, decided at the first hit (camera.hpp:492-517).
    if sp.want_spec:
        spec0 = at0 & is_spec & live
        refl_dir = soa.reflect(soa.normalize(d), soa.normalize(normal))
        is_specular = soa.dot(soa.normalize(sc_dir), refl_dir) > 0.9
        entering = soa.dot(sc_dir, normal) < 0.0
        spec_live = hit & scattered
        no = torch.zeros_like(spec_live)
        refl_new = spec_live & is_specular if sp.use_reflection else no
        refr_new = (spec_live & ~is_specular & entering
                    if sp.use_refraction else no)
        to_refl = torch.where(spec0, refl_new, to_refl)
        to_refr = torch.where(spec0, refr_new, to_refr)
        attn0 = soa.where(spec0, attenuation, attn0)
        # Spec paths routed to neither buffer are dead work.
        active = active & ~(spec0 & ~(to_refl | to_refr))

    n = sp.n_pixels
    slot = li - sp.pixel_offset
    contrib, tgts = [], []
    done = live & ~active
    done_beauty = done & ~is_spec
    tgts.append(torch.where(done_beauty, slot, n))
    contrib += [torch.where(done_beauty, rad[k], 0.0) for k in range(3)]

    # AOVs of the camera segment: bounce-0 beauty lanes whose absolute
    # sample id is below the aux budget (camera.hpp:463-487).
    if sp.aovs:
        is_aux = live & at0 & (samp < sp.aux) & ~is_spec
        tgts.append(torch.where(is_aux, slot, n))
        if "albedo" in sp.aovs:
            for k in range(3):
                alb = torch.where(is_diel, 1.0, tex3[k])
                alb = torch.where(is_emit, torch.clamp(tex3[k], max=1.0), alb)
                alb = torch.where(is_iso, 0.0, alb)
                contrib.append(torch.where(is_aux & hit, alb, 0.0))
        if "normal" in sp.aovs:
            nn = soa.normalize(normal)
            for k, base in enumerate((_BP_CAM_U, _BP_CAM_V, _BP_CAM_W)):
                c = nn[0] * bp[base] + nn[1] * bp[base + 1] + nn[2] * bp[base + 2]
                c = (c + 1.0) * 0.5
                contrib.append(torch.where(
                    is_aux, torch.where(hit, c, 0.5 if k < 2 else 1.0), 0.0))
        if "z_depth" in sp.aovs:
            zval = 1.0 - torch.clamp(t_hit / sp.z_max, 0.0, 1.0)
            contrib.append(torch.where(is_aux & hit, zval, 0.0))

    # Finished spec paths: the firefly clamp on the continuation, then the
    # stored first-hit attenuation (camera.hpp:499-509).
    if sp.want_spec:
        luma = 0.2126 * soa.length(rad)
        fscale = torch.where(luma > 2.0, 2.0 / torch.clamp(luma, min=1e-12), 1.0)
        spec_c = tuple(attn0[k] * rad[k] * fscale for k in range(3))
        for route in (to_refl, to_refr):
            dr = done & route
            tgts.append(torch.where(dr, slot, n))
            contrib += [torch.where(dr, spec_c[k], 0.0) for k in range(3)]

    # Respawn: lane -> work id = next_work + inclusive prefix count of
    # free lanes (lane order) - 1, spawning while below total_work. Work
    # ids from n_beauty on are the spec lanes of the same (pixel, sample).
    free = ~live | done
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    new_w = next_work.to(torch.int64) + rank
    can_spawn = free & (new_w < sp.total_work)
    w = torch.clamp(new_w, 0, sp.total_work - 1)
    if sp.want_spec:
        new_spec = w >= sp.n_beauty
        w = torch.where(new_spec, w - sp.n_beauty, w)
    wf = w.to(torch.float32)
    sr = torch.floor((wf + 0.5) * (1.0 / n))
    sli = wf - sr * n
    sr = torch.where(sli < 0.0, sr - 1.0, torch.where(sli >= n, sr + 1.0, sr))
    sli = wf - sr * n
    new_li = sli.to(torch.int32) + sp.pixel_offset
    new_samp = sp.sample_offset + sr.to(torch.int32)
    so, sd = _raygen(bp, sp.seed, new_li, new_samp, sp.width)

    sel = lambda fresh, old: torch.where(can_spawn, fresh, old)
    n_live = (live & active) | can_spawn
    rows_f = [
        sel(so[0], torch.where(active, sc_origin[0], o[0])),
        sel(so[1], torch.where(active, sc_origin[1], o[1])),
        sel(so[2], torch.where(active, sc_origin[2], o[2])),
        sel(sd[0], torch.where(active, sc_dir[0], d[0])),
        sel(sd[1], torch.where(active, sc_dir[1], d[1])),
        sel(sd[2], torch.where(active, sc_dir[2], d[2])),
        sel(one, thr[0]), sel(one, thr[1]), sel(one, thr[2]),
        sel(zero, rad[0]), sel(zero, rad[1]), sel(zero, rad[2])]
    rows_i = [n_live, torch.where(can_spawn, 0, bounce + 1),
              sel(new_samp, samp), sel(new_li, li)]
    if sp.want_spec:
        rows_f += [sel(one, attn0[k]) for k in range(3)]
        rows_i += [sel(new_spec, is_spec), can_spawn.logical_not() & to_refl,
                   can_spawn.logical_not() & to_refr]
    state_f = torch.stack(rows_f)
    state_i = torch.stack([r.to(torch.int32) for r in rows_i])
    total_free = free.sum()
    next_out = torch.clamp(next_work.to(torch.int64) + total_free,
                           max=sp.total_work).to(torch.int32).reshape(1)
    seg_out = (segments + live.sum()).reshape(1)
    live_count = n_live.sum().to(torch.int32).reshape(1)
    tgt = torch.stack([x.to(torch.int32) for x in tgts])
    return (state_f, state_i, torch.stack(contrib), tgt, next_out, seg_out,
            live_count)


def shade_advance(tables: FusedTables, rec, state_f, state_i, next_work,
                  segments, bparams, sp: StepParams):
    """K3: shade every lane, advance its path, and respawn finished lanes
    from the work counter. CPU tensors take `shade_advance_plain`; CUDA
    tensors launch csrc/shade_advance.cu, the variant that `sp` selects.
    Same signature and results. `launches` counts beauty-variant launches,
    `features_launches` those of the fog / AOV / spec variants."""
    if rec.device.type == "cpu":
        return shade_advance_plain(tables, rec, state_f, state_i, next_work,
                                   segments, bparams, sp)
    kernels.require_cuda(rec, state_f, dtype=torch.float32)
    scalars, outs = _k3_launch_parts(tables, state_f, state_i, next_work,
                                     segments, bparams, sp)
    out_f, out_i, counts, next_out, seg_out, live_count = outs
    p, dev = rec.shape[1], rec.device
    n_c, n_t = output_rows(sp)
    contrib = torch.empty((n_c, p), dtype=torch.float32, device=dev)
    tgt = torch.empty((n_t, p), dtype=torch.int32, device=dev)
    kernels.launch(
        "shade_advance_launch", rec, state_f, state_i, p, *scalars,
        next_work, segments, out_f, out_i, contrib, tgt, counts, next_out,
        seg_out, live_count)
    if sp.features:
        kernels.count(shade_advance, "features_launches")
    else:
        kernels.count(shade_advance)
    return out_f, out_i, contrib, tgt, next_out, seg_out, live_count


shade_advance.launches = 0
shade_advance.features_launches = 0


def _k3_launch_parts(tables: FusedTables, state_f, state_i, next_work,
                     segments, bparams, sp: StepParams):
    """What K3's two C entries share: the checks of the state and tables,
    the launch's scalar block (bparams through n_volumes), and the outputs
    it writes, (out_f, out_i, counts, next_out, seg_out, live_count)."""
    kernels.require_cuda(state_f, bparams, tables.atlas_rows,
                         tables.grad_rows, tables.env_rows, tables.vparams,
                         dtype=torch.float32)
    kernels.require_cuda(state_i, next_work, dtype=torch.int32)
    kernels.require_cuda(segments, dtype=torch.int64)
    if (state_f.shape[0], state_i.shape[0]) != state_rows(sp):
        raise ValueError(f"state rows {state_f.shape[0]}/{state_i.shape[0]}, "
                         f"expected {state_rows(sp)}")
    if sp.n_volumes > tables.vparams.shape[0]:
        raise ValueError("n_volumes exceeds the volume table")
    p, dev = state_f.shape[1], state_f.device
    aov_mask = sum(1 << k for k, name in enumerate(AOVS) if name in sp.aovs)
    scalars = (
        bparams, tables.atlas_rows, tables.grad_rows, tables.env_rows,
        tables.vparams, sp.seed, sp.sample_offset, sp.pixel_offset,
        sp.n_pixels, float(np.float32(1.0 / sp.n_pixels)), sp.width,
        float(np.float32(1.0 / sp.width)), sp.total_work, sp.max_depth,
        sp.env_mode, sp.aux, float(sp.z_max), aov_mask,
        int(sp.use_reflection), int(sp.use_refraction), sp.n_beauty,
        sp.n_volumes)
    outs = (torch.empty_like(state_f), torch.empty_like(state_i),
            torch.empty((3, -(-p // 256)), dtype=torch.int32, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev),
            torch.empty((1,), dtype=torch.int64, device=dev),
            torch.empty((1,), dtype=torch.int32, device=dev))
    return scalars, outs


# ---------------------------------------------------------------------------
# K3 fused: decode, shade, advance, accumulate, respawn
# ---------------------------------------------------------------------------

def new_accumulator(sp: StepParams, device) -> torch.Tensor:
    """The flat accumulator of a pool render (f32, zeros): channel c of
    acc_channels(sp) at [c * stride, c * stride + n_pixels), stride =
    n_pixels + 1; the last slot of each channel is the dummy target of
    K3's unfused outputs, which K3 fused never adds to."""
    return torch.zeros((len(acc_channels(sp)) * (sp.n_pixels + 1),),
                       dtype=torch.float32, device=device)


def shade_accumulate_plain(tables: FusedTables, hits, state_f, state_i,
                           next_work, segments, steps, aparams, bparams,
                           sp: StepParams, acc):
    """Plain PyTorch K3 fused: `decode_plain` of the hits, then
    `shade_advance_plain`, then one index_add_ of its outputs into acc
    (new_accumulator's layout) over the lanes whose target is a pixel,
    channel by channel, each channel in lane order. acc and steps (i64[1],
    plus one when the step began with live lanes) are updated in place.
    Returns (state_f, state_i, next_work, segments, live_count, steps)."""
    steps += (state_i[0] > 0).any().to(torch.int64)
    rec = decode_plain(tables, state_f[:6], *hits, aparams)
    (state_f, state_i, contrib, tgt, next_work, segments,
     live_count) = shade_advance_plain(tables, rec, state_f, state_i,
                                       next_work, segments, bparams, sp)
    channels = acc_channels(sp)
    idx = tgt[[t for _, t in channels]].to(torch.int64)
    vals = contrib[[c for c, _ in channels]]
    real = idx < sp.n_pixels
    offsets = (torch.arange(len(channels), dtype=torch.int64,
                            device=acc.device) * (sp.n_pixels + 1))[:, None]
    acc.index_add_(0, (idx + offsets)[real], vals[real])
    return state_f, state_i, next_work, segments, live_count, steps


def shade_accumulate(tables: FusedTables, hits, state_f, state_i, next_work,
                     segments, steps, aparams, bparams, sp: StepParams, acc):
    """K3 fused, one pool step after K1: decode the closest hits `hits` =
    (t, idx, typ) of the rays state_f[:6], shade and advance every lane,
    add what each lane finishes into acc, and respawn free lanes from the
    work counter. acc and steps are updated in place (see
    `shade_accumulate_plain`, which CPU tensors take; CUDA tensors launch
    csrc/shade_advance.cu's shade_kernel<..., FUSED = true>, the variant
    that `sp` selects). Returns (state_f, state_i, next_work, segments,
    live_count, steps). On the card a pixel that two lanes finish in one
    step gets their sums in no fixed order. `launches` counts beauty-
    variant launches, `features_launches` the others."""
    if state_f.device.type == "cpu":
        return shade_accumulate_plain(tables, hits, state_f, state_i,
                                      next_work, segments, steps, aparams,
                                      bparams, sp, acc)
    t, idx, typ = hits
    kernels.require_cuda(t, state_f, aparams, acc, tables.rectab,
                         tables.mattab, tables.texmeta, dtype=torch.float32)
    kernels.require_cuda(idx, typ, dtype=torch.int32)
    kernels.require_cuda(steps, dtype=torch.int64)
    scalars, outs = _k3_launch_parts(tables, state_f, state_i, next_work,
                                     segments, bparams, sp)
    out_f, out_i, counts, next_out, seg_out, live_count = outs
    p = state_f.shape[1]
    if t.shape[0] != p:
        raise ValueError(f"{t.shape[0]} hits for {p} lanes")
    stride = sp.n_pixels + 1
    if acc.numel() != len(acc_channels(sp)) * stride:
        raise ValueError(f"accumulator of {acc.numel()} values, expected "
                         f"{len(acc_channels(sp))} channels x {stride}")
    eh, ew = tables.env_hw if tables.env_hw is not None else (0, 0)
    kernels.launch(
        "shade_accumulate_launch", t, idx, typ, state_f, state_i, p,
        *scalars, aparams, tables.rectab, tables.rectab.shape[0],
        tables.mattab, tables.mattab.shape[0], tables.texmeta,
        tables.texmeta.shape[0], tables.scan.counts[0], tables.scan.counts[1],
        1 if tables.scan.counts[2] else 0, float(tables.atlas_hw[0]),
        float(tables.atlas_hw[1]), 1 if tables.env_hw is not None else 0,
        float(eh), float(ew), stride, next_work, segments, out_f, out_i, acc,
        counts, next_out, seg_out, live_count, steps)
    if sp.features:
        kernels.count(shade_accumulate, "features_launches")
    else:
        kernels.count(shade_accumulate)
    return out_f, out_i, next_out, seg_out, live_count, steps


shade_accumulate.launches = 0
shade_accumulate.features_launches = 0


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


_turns = threading.local()


class HostTurns:
    """The host, taken in turns by the threads that render windows on the
    card (parallel/render.py): a thread holds its turn (`held`) while it
    runs host code and gives it up while its pool waits on the card
    (_wait). Without turns each of the pool's torch ops and launches hands
    the interpreter lock between the threads, and windows of one card
    render slower than one after another (tools/bench_windows.py,
    no_turns)."""

    def __init__(self):
        self._lock = threading.Lock()

    def acquire(self) -> None:
        self._lock.acquire()

    def release(self) -> None:
        self._lock.release()

    @contextlib.contextmanager
    def held(self):
        """The block in this thread's turns."""
        _turns.current = self
        self.acquire()
        try:
            yield
        finally:
            self.release()
            _turns.current = None


def _wait(ev) -> None:
    """ev.synchronize(), giving up the host turn meanwhile (HostTurns)."""
    turns = getattr(_turns, "current", None)
    if turns is None:
        with spans.span("pool.wait"):
            ev.synchronize()
        return
    turns.release()
    try:
        with spans.span("pool.wait"):
            ev.synchronize()
    finally:
        turns.acquire()


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


def render_pool_fused(scene, cam, env, seed: int, config, aux: int,
                      sample_offset=0, with_stats: bool = False,
                      pixel_offset: int = 0, n_pixels_local: int | None = None):
    """Per-pixel sums (integrator.SampleBuffers, each f32[n, 3]) of
    `config.samples_per_pixel` samples from `sample_offset` on, through the
    fused pool on the scene's device: beauty, the AOVs and the split passes
    that `config` enables (zeros for the others). The AOVs sum the camera
    segments of the samples whose absolute id is below `aux`, the whole
    render's AOV budget, so that sample chunks add up to one call.

    pixel_offset / n_pixels_local render the pixel window [pixel_offset,
    pixel_offset + n_pixels_local) of the frame (n = n_pixels_local; by
    default the whole frame, n = config.n_pixels): lanes keep global pixel
    ids, so each pixel's samples are those of the full-frame render.
    A window past the frame's end traces phantom pixels, which the caller
    drops (parallel/render.py).

    with_stats also returns {"segments", "steps"}: path segments traced
    (int64 on the device, exact) and steps taken with live lanes."""
    from .integrator import SampleBuffers

    with spans.span("pool.call"):
        dev = scene.spheres.center.device
        n = n_pixels_local if n_pixels_local is not None else config.n_pixels
        spp = config.samples_per_pixel
        aovs = tuple(name for name, on in zip(AOVS, (
            config.use_albedo, config.use_normal, config.use_z_depth)) if on)
        want_spec = config.use_reflection or config.use_refraction
        n_beauty = n * spp
        total_work = n_beauty * (2 if want_spec else 1)
        p = pool_size(config, total_work)
        with spans.span("pool.setup"):
            with spans.span("tables.build"):
                tables = build_tables(scene, env, config.env_mode)
            aparams = _aparams(env, dev)
            bparams = _bparams(cam, env, dev)
            n_volumes = (scene.volumes.count if scene.volumes is not None
                         else 0)
            sp = StepParams(
                seed=rng.seed_from_int(seed), sample_offset=int(sample_offset),
                n_pixels=n, width=config.width, total_work=total_work,
                max_depth=config.max_depth, env_mode=config.env_mode,
                aux=int(aux), z_max=float(config.z_depth_max_dist),
                aovs=aovs, use_reflection=config.use_reflection,
                use_refraction=config.use_refraction, n_beauty=n_beauty,
                n_volumes=n_volumes, pixel_offset=int(pixel_offset))

            # Initial fill: the same (pixel, sample) decode as the respawn.
            w0 = torch.arange(p, dtype=torch.int64, device=dev)
            wc = torch.clamp(w0, max=total_work - 1)
            spec0 = wc >= n_beauty
            wc = torch.where(spec0, wc - n_beauty, wc)
            samp_rel = wc // n
            li0 = (wc - samp_rel * n + pixel_offset).to(torch.int32)
            samp0 = (sample_offset + samp_rel).to(torch.int32)
            lr0 = rng.LaneRng(sp.seed, rng.u32(li0), rng.u32(samp0), 0)
            o0, d0 = camera_mod.generate_rays_soa(cam.to(dev), lr0, li0,
                                                  config.width)
            live0 = (w0 < total_work).to(torch.int32)
            ones = torch.ones((p,), dtype=torch.float32, device=dev)
            zeros = torch.zeros((p,), dtype=torch.float32, device=dev)
            zeros_i = torch.zeros_like(live0)
            rows_f = [*o0, *d0, ones, ones, ones, zeros, zeros, zeros]
            rows_i = [live0, zeros_i, samp0, li0]
            if want_spec:
                rows_f += [ones, ones, ones]
                rows_i += [spec0.to(torch.int32), zeros_i, zeros_i]
            state_f = torch.stack(rows_f)
            state_i = torch.stack(rows_i)
            next_work = torch.full((1,), min(p, total_work),
                                   dtype=torch.int32, device=dev)
            live_count = live0.sum().to(torch.int32).reshape(1)
            segments = torch.zeros((1,), dtype=torch.int64, device=dev)
            steps = torch.zeros((1,), dtype=torch.int64, device=dev)

            # One flat accumulator, channel c at [c * stride, c * stride + n);
            # K3 fused adds each lane's finished values to it.
            acc = new_accumulator(sp, dev)
            stride = n + 1

        lag = 1 if dev.type == "cpu" else LIVE_LAG
        with spans.span("pool.loop"):
            pending = collections.deque([_host_copy(live_count)])
            while True:
                if len(pending) >= lag:
                    ev, live_host = pending.popleft()
                    if ev is not None:
                        _wait(ev)
                    if int(live_host[0]) == 0:
                        break
                # Steps after the pool drains are no-ops: nothing is live,
                # nothing spawns, nothing is added and the step count stays.
                with spans.span("pool.launch"):
                    hits = k1.closest_hit(state_f[:6], T_MIN, tables.scan)
                    (state_f, state_i, next_work, segments, live_count,
                     steps) = shade_accumulate(
                        tables, hits, state_f, state_i, next_work, segments,
                        steps, aparams, bparams, sp, acc)
                pending.append(_host_copy(live_count))

        with spans.span("pool.finish"):
            order = ("beauty",) + aovs + (
                ("reflection", "refraction") if want_spec else ())
            zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

            def get(name):
                if name not in order:
                    return zeros3
                c0 = 3 * order.index(name) * stride
                return acc[c0:c0 + 3 * stride].reshape(
                    3, stride)[:, :n].T.contiguous()

            out = SampleBuffers(*(get(f) for f in SampleBuffers._fields))
            if with_stats:
                ev, counts = _host_copy(torch.cat([segments, steps]))
                if ev is not None:
                    _wait(ev)
                return out, {"segments": int(counts[0]),
                             "steps": int(counts[1])}
            return out
