"""P3: bisect the hit-record decode (twin of the reference's
tools/probe_decode.py, whose Pallas kernel this ports as
csrc/probe_decode.cu; its d3 is K2 itself, ops/fused_step.decode).

    python -m raytracer_project_tpu_torch.tools.probe_decode <variant> [--device cpu]
  d0    row fetch only: hit, t, then the fetched row's columns 0..21
  d1    d0 + sphere/tri/box record decoders + selects: hit, t, normal,
        tangent, bitangent, front, u, v, mat, then columns 0..8
  d2    d1 + material/texture-metadata fetches: d1's first 15 rows, then
        material columns 0, 3, 4, texture-metadata columns 0..3, the
        texture id and material column 6
  d3    the full decode (K2)
  d3w4096, d3u  the reference's Mosaic tiling twins of d3 (D_BLOCK 4096,
        unwindowed one-hots); on the card they are d3

Every variant writes f32 [24, P] rows. The reference's d0-d2 index its
fetch as a [B, 28] matrix, which no longer matches its decode's
transposed [28, B] fetch (they do not trace); these follow the current
layout: the fetched row is the hit's row of the packed table, clipped to
the table. The hits are K1's on the showcase camera rays of the 800x450
main path (P lanes of its first pool fill, the probe's 8,192 by default).

On the card `decode_stage` launches csrc/probe_decode.cu's stage_kernel.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..core import rng
from ..core.constants import T_MAX, T_MIN
from ..models import camera as tcam
from ..models import environment as tenv
from ..models import presets
from ..ops import closest_hit as k1
from ..ops import fused_step as fs
from . import arg_parser, build, time_ms

VARIANTS = ("d0", "d1", "d2", "d3", "d3w4096", "d3u")
P = 8192
STAGES = {"d0": 0, "d1": 1, "d2": 2}
CAM_KW = dict(image_width=800, image_height=450, vfov=30.0,
              lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


def camera_hits(p: int, device="cuda"):
    """(tables, od, (t, idx, type), aparams): the showcase tables, the
    camera rays of the first p lanes of the 800x450 pool (seed 0) and
    their closest hits from K1."""
    dev = torch.device(device)
    scene = presets.showcase_scene().to(dev)
    env = tenv.make_environment(**ENV_KW)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    n = CAM_KW["image_width"] * CAM_KW["image_height"]
    w = torch.arange(p, device=dev)
    li = (w % n).to(torch.int32)
    samp = (w // n).to(torch.int32)
    cam = tcam.make_camera(**CAM_KW).to(dev)
    o, d = tcam.generate_rays_soa(cam, rng.LaneRng(
        rng.seed_from_int(0), rng.u32(li), rng.u32(samp), 0), li,
        CAM_KW["image_width"])
    od = torch.stack([*o, *d]).contiguous()
    hit = k1.closest_hit(od, T_MIN, tables.scan)
    return tables, od, hit, fs._aparams(env, dev)


def decode_stage_plain(stage: int, tables, od, t, idx, typ):
    """Plain PyTorch P3 stage 0, 1 or 2: f32 [24, P] rows."""
    grow, parts = fs.decode_records_plain(tables, od, t, idx, typ)
    head = [(t < T_MAX).to(torch.float32), t]
    if stage == 0:
        return torch.stack(head + [grow[:, k] for k in range(22)])
    _, normal, tangent, bitangent, front, u, v, mat = parts
    rows = head + [*normal, *tangent, *bitangent, front.to(torch.float32), u,
                   v, mat.to(torch.float32)]
    if stage == 1:
        return torch.stack(rows + [grow[:, k] for k in range(9)])
    mrow = tables.mattab[torch.clamp(mat, 0.0, tables.mattab.shape[0] - 1)
                         .to(torch.int64)]
    tex_id = mrow[:, 5]
    tmeta = tables.texmeta[torch.clamp(tex_id, 0.0, tables.texmeta.shape[0] - 1)
                           .to(torch.int64)]
    return torch.stack(rows + [mrow[:, 0], mrow[:, 3], mrow[:, 4], tmeta[:, 0],
                               tmeta[:, 1], tmeta[:, 2], tmeta[:, 3], tex_id,
                               mrow[:, 6]])


def decode_stage(stage: int, tables, od, t, idx, typ):
    """P3 stage 0, 1 or 2 of the hits (t, idx, typ) of the rays od
    f32[6, P]: CPU tensors take `decode_stage_plain`, CUDA tensors launch
    csrc/probe_decode.cu's stage_kernel, which reads the packed rows in
    16 B pieces and so takes `tables.rectab` 16 B aligned. Returns f32
    [24, P]."""
    if stage not in (0, 1, 2):
        raise ValueError(f"stage {stage} is not 0, 1 or 2")
    if od.device.type == "cpu":
        return decode_stage_plain(stage, tables, od, t, idx, typ)
    if tables.rectab.data_ptr() % 16:
        raise ValueError("the stage kernel takes a 16 B aligned rectab")
    kernels.require_cuda(od, t, tables.rectab, tables.mattab, tables.texmeta,
                         dtype=torch.float32)
    kernels.require_cuda(idx, typ, dtype=torch.int32)
    p = od.shape[1]
    out = torch.empty((fs._RO_ROWS, p), dtype=torch.float32, device=od.device)
    kernels.launch(
        "probe_decode_stage", stage, od, t, idx, typ, p,
        tables.rectab, tables.rectab.shape[0], tables.mattab,
        tables.mattab.shape[0], tables.texmeta, tables.texmeta.shape[0],
        tables.scan.counts[0], tables.scan.counts[1],
        1 if tables.scan.counts[2] else 0, out)
    kernels.count(decode_stage)
    return out


decode_stage.launches = 0


def variant_fn(variant: str, tables, od, hit, aparams):
    """The call that `variant` times: a decode stage, or K2 for d3*."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant in STAGES:
        return lambda: decode_stage(STAGES[variant], tables, od, *hit)
    return lambda: fs.decode(tables, od, *hit, aparams)


def run(variant: str, tables, od, hit, aparams, n: int = 20) -> dict:
    ms = time_ms(variant_fn(variant, tables, od, hit, aparams), od.device, n)
    print(f"OK variant={variant} p={od.shape[1]} {ms:.5f} ms/launch",
          flush=True)
    return {"variant": variant, "ms": ms}


def main(variant: str, device="cuda") -> dict:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    dev = torch.device(device)
    build("probe_decode" if variant in STAGES else "decode", dev)
    return run(variant, *camera_hits(P, dev))


if __name__ == "__main__":
    ap = arg_parser(__doc__)
    ap.add_argument("variant", choices=VARIANTS)
    a = ap.parse_args()
    main(a.variant, a.device)
