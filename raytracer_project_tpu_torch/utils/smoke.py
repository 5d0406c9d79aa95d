"""On-device smoke gate of the port: a fast fail for CUDA kernel faults
and hangs (twin of raytracer_project_tpu/utils/smoke.py).

The CPU tests run every kernel's plain PyTorch version, so a kernel that
builds but faults, hangs or draws a wrong image on the card passes them.
This module is the card's gate, in named stages with flushed heartbeat
lines, so that the tail of a watchdog's timeout names the stage that
wedged:

  fused-fast      64x36 @ 2 spp showcase through the fused pool (K1, K3
                  fused); SMOKE_FAST=1 runs only this stage;
  fused-features  the fog showcase (density 0.02) at 64x36 @ 4 spp with
                  every AOV and both split passes through the fused pool:
                  beauty, albedo and reflection each against a golden;
  pool-render     128x72 @ 4 spp showcase through the unfused pool
                  (RAYTRACER_TPU_NO_FUSED=1);
  hit-agree       K4 (the port's route for the reference's
                  intersect_brute_pallas) against the exact brute-force
                  oracle on 512 camera rays;
  bvh-traverse    the BVH traversal against the brute-force oracle on a
                  9,000-sphere scene.

Run as ``python -m raytracer_project_tpu_torch.utils.smoke [--device cpu]``
(exit code 0 when every stage passes; nonzero with the reason otherwise,
also without a card unless `--device cpu` asks for the CPU). The port's
bench runs it in a subprocess under a timeout before it times anything: a
hung kernel cannot be interrupted in-process.

Two goldens per image:

  tests/goldens/smoke_<name>.npz            the CPU golden, the semantic
      reference: the JAX package's render on the CPU (read only here);
  raytracer_project_tpu_torch/goldens/smoke_<name>_cuda.npz
      the device golden, the regression reference: the port's render on
      the card (tools/make_device_goldens.py), with the card's name
      (`device`) and CUDA version (`cuda`) it was made with.

On the CPU the port's render is held against the CPU golden at mean |d|
<= 0.01 and the stage's outlier budget. On the card K1's and K4's t are
f32 fused multiply-add chains where the plain versions sum bf16 parts in
XLA's order, so a card render is not the CPU's: an ulp of t flips a hit
and reroutes a path (speckle). The card's check is two-sided: TIGHT
against the device golden (mean |d| <= 1e-5; the fused and unfused pools
add a pixel's lanes with atomics in no fixed order, which moves a sum by
an ulp, never a path) and STATISTICAL against the CPU golden (mean |d|
<= 0.06, at most 20% of pixels over 0.05), which a systematically wrong
image fails (30-100% of pixels off). A device golden made on another card
or CUDA version says nothing of this one: its tight check is skipped with
a logged reason, and the statistical check still runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.integrator import resolve_device

_T0 = time.perf_counter()

CPU_GOLDEN_DIR = Path(__file__).resolve().parents[2] / "tests" / "goldens"
DEVICE_GOLDEN_DIR = Path(__file__).resolve().parents[1] / "goldens"
DEVICE_SUFFIX = "_cuda"

# Cross-backend statistical budgets (card render against the CPU golden),
# the reference's (utils/smoke.py:98-99): speckle from flipped hits stays
# below them, a systematically wrong image runs mean >= 0.1 with 30-100%
# of pixels off.
_XBACKEND_MEAN = 0.06
_XBACKEND_FRAC = 0.20
# Device-golden budget: the same kernels on the same card and CUDA
# version; the atomics' order moves sums by ulps only.
_DEVICE_MEAN = 1e-5


def _hb(msg: str) -> None:
    print(f"SMOKE [{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def _fail(msg: str) -> int:
    print(f"SMOKE FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _golden_path(name: str) -> Path:
    """A device golden (name ending in _cuda) in the port's goldens/, a
    CPU golden in tests/goldens/."""
    base = DEVICE_GOLDEN_DIR if name.endswith(DEVICE_SUFFIX) else CPU_GOLDEN_DIR
    return base / f"{name}.npz"


class DeviceInfo(NamedTuple):
    """What the golden policy needs of a device: its type ("cpu" or
    "cuda"), and on the card its name and CUDA version."""

    type: str
    name: str = ""
    cuda: str = ""


def device_info(device) -> DeviceInfo:
    dev = torch.device(device)
    if dev.type != "cuda":
        return DeviceInfo("cpu")
    return DeviceInfo("cuda", torch.cuda.get_device_name(dev),
                      str(torch.version.cuda))


def _diff(img, ref):
    d = np.abs(img - ref)
    return float(d.mean()), float((d.max(axis=-1) > 0.05).mean())


def _check_image(beauty: np.ndarray, golden_name: str, stage: str,
                 max_frac: float = 0.01, device: DeviceInfo = DeviceInfo("cpu"),
                 device_dir: Path | None = None):
    """The reference's two-golden policy (utils/smoke.py:105-178) for an
    image `beauty` [H, W, 3] rendered on `device`; device goldens are read
    from `device_dir` (default the port's goldens/). Finite and not all
    black always; on the CPU the CPU golden at mean <= 0.01 and
    `max_frac`; on the card the device golden at mean <= _DEVICE_MEAN
    (skipped when it was made on another card or CUDA version), then the
    CPU golden under the cross-backend budgets. A missing golden is
    logged. Returns an error string or None."""
    if not np.isfinite(beauty).all():
        bad = int(np.count_nonzero(~np.isfinite(beauty)))
        return f"{stage}: non-finite pixels ({bad} bad values)"
    if beauty.max() <= 0.0:
        return f"{stage}: image is all-black"

    path = _golden_path(golden_name)
    cpu_ref = None
    if path.exists():
        cpu_ref = np.load(path)["beauty"]
        if cpu_ref.shape != beauty.shape:
            return (f"{stage}: golden shape {cpu_ref.shape} != render "
                    f"{beauty.shape}")
    if device.type != "cuda":
        if cpu_ref is None:
            _hb(f"{stage}: golden {golden_name} missing — "
                f"finite/nonzero only")
            return None
        mean_diff, frac_off = _diff(beauty, cpu_ref)
        _hb(f"{stage}: golden diff mean={mean_diff:.5f} "
            f"frac(>0.05)={frac_off:.4f} (budget {max_frac})")
        if mean_diff > 0.01 or frac_off > max_frac:
            return (f"{stage}: image disagrees with CPU golden "
                    f"(mean|d|={mean_diff:.5f} frac>0.05={frac_off:.4f})")
        return None

    # The card: the tight device-golden regression check ...
    dev_name = golden_name + DEVICE_SUFFIX
    dev_path = Path(device_dir or DEVICE_GOLDEN_DIR) / f"{dev_name}.npz"
    if dev_path.exists():
        with np.load(dev_path) as g:
            dev_ref = g["beauty"]
            made = (str(g["device"]) if "device" in g.files else "?",
                    str(g["cuda"]) if "cuda" in g.files else "?")
        if made != (device.name, device.cuda):
            _hb(f"{stage}: device golden {dev_name} was made on {made[0]} "
                f"(CUDA {made[1]}), this card is {device.name} (CUDA "
                f"{device.cuda}) — tight check skipped, statistical CPU "
                f"check only")
        else:
            if dev_ref.shape != beauty.shape:
                return (f"{stage}: device golden shape {dev_ref.shape} != "
                        f"render {beauty.shape}")
            mean_dev, frac_dev = _diff(beauty, dev_ref)
            _hb(f"{stage}: device-golden diff mean={mean_dev:.2e} "
                f"max={float(np.abs(beauty - dev_ref).max()):.2e} "
                f"(budget {_DEVICE_MEAN:.0e})")
            if mean_dev > _DEVICE_MEAN:
                return (f"{stage}: device render drifted from device golden "
                        f"(mean|d|={mean_dev:.3e} frac>0.05={frac_dev:.4f} — "
                        f"kernel regression, or an intentional change "
                        f"needing tools/make_device_goldens.py)")
    else:
        _hb(f"{stage}: device golden {dev_name} missing — "
            f"statistical CPU check only")
    # ... plus the statistical cross-backend check.
    if cpu_ref is None:
        _hb(f"{stage}: golden {golden_name} missing — finite/nonzero only")
        return None
    mean_diff, frac_off = _diff(beauty, cpu_ref)
    _hb(f"{stage}: CPU-golden diff mean={mean_diff:.5f} "
        f"frac(>0.05)={frac_off:.4f} (budgets {_XBACKEND_MEAN}/"
        f"{_XBACKEND_FRAC})")
    if mean_diff > _XBACKEND_MEAN or frac_off > _XBACKEND_FRAC:
        return (f"{stage}: image systematically disagrees with CPU golden "
                f"(mean|d|={mean_diff:.5f} frac>0.05={frac_off:.4f})")
    return None


def _showcase(width: int, height: int, **scene_kw):
    from ..models import camera, environment, presets

    scene = presets.showcase_scene(with_bvh=True, with_meshes=True, **scene_kw)
    cam = camera.make_camera(
        image_width=width, image_height=height, vfov=30.0,
        lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
        defocus_angle=0.0, focus_dist=10.0)
    env = environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                       sun_intensity=6.0)
    return scene, cam, env


def _render(label, inputs, cfg, device, engine):
    """integrator.render of the stage's frame (seed 0) on `device` (the
    card when None); raises RuntimeError when it did not take `engine`."""
    from ..ops import integrator

    out, stats = integrator.render(*inputs, 0, cfg, device=device,
                                   with_stats=True)
    if stats.get("engine") != engine:
        raise RuntimeError(f"{label}: rendered on the {stats.get('engine')} "
                           f"engine, expected {engine}")
    return {k: v.cpu().numpy() for k, v in out.items()}


def render_fused_fast(device=None):
    """The fused-fast stage's render on `device` (the card when None):
    [(golden_name, label, max_frac, img)], shared by the stage, the golden
    tools and the card tests."""
    from ..models import environment
    from ..ops import fused_step, integrator

    inputs = _showcase(64, 36)
    cfg = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=2, max_depth=10,
        env_mode=environment.PHYSICAL_SUN,
        use_albedo=False, use_normal=False, use_z_depth=False,
        wavefront=True)
    if not fused_step.fused_supported(inputs[0], cfg, inputs[2]):
        raise RuntimeError("fused-fast: showcase no longer fused_supported")
    _hb(f"fused-fast: running 64x36@2spp on {device} (fused pool)")
    beauty = _render("fused-fast", inputs, cfg, device, "fused")["beauty"]
    _hb(f"fused-fast: done, mean={beauty.mean():.4f}")
    return [("smoke_fused_64x36", "fused-fast", 0.01, beauty)]


def render_fused_features(device=None):
    """The fog showcase (density 0.02) at 64x36 @ 4 spp through the fused
    pool with every AOV and both split passes: beauty, albedo and
    reflection, each with the 4% outlier budget (the fog's free flights
    and the specular classifier make this frame the most chaotic)."""
    from ..models import environment
    from ..ops import fused_step, integrator

    inputs = _showcase(64, 36, use_fog=True, fog_density=0.02)
    cfg = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=4, max_depth=10,
        env_mode=environment.PHYSICAL_SUN,
        use_albedo=True, use_normal=True, use_z_depth=True,
        use_reflection=True, use_refraction=True, wavefront=True)
    if not fused_step.fused_supported(inputs[0], cfg, inputs[2]):
        raise RuntimeError("fused-features: fog showcase not "
                           "fused_supported")
    _hb(f"fused-features: running 64x36@4spp fog+AOV+spec on {device} "
        f"(fused pool)")
    out = _render("fused-features", inputs, cfg, device, "fused")
    images = []
    for name in ("beauty", "albedo", "reflection"):
        _hb(f"fused-features: {name} mean={out[name].mean():.4f}")
        images.append((f"smoke_features_{name}_64x36",
                       f"fused-features:{name}", 0.04, out[name]))
    return images


def render_pool(device=None):
    """128x72 @ 4 spp showcase through the unfused pool
    (RAYTRACER_TPU_NO_FUSED=1 while it renders, its old value restored)."""
    from ..models import environment
    from ..ops import integrator

    inputs = _showcase(128, 72)
    cfg = integrator.RenderConfig(
        width=128, height=72, samples_per_pixel=4, max_depth=10,
        env_mode=environment.PHYSICAL_SUN,
        use_albedo=False, use_normal=False, use_z_depth=False,
        wavefront=True)
    _hb(f"pool-render: running 128x72@4spp on {device} (unfused pool)")
    old = os.environ.get("RAYTRACER_TPU_NO_FUSED")
    os.environ["RAYTRACER_TPU_NO_FUSED"] = "1"
    try:
        beauty = _render("pool-render", inputs, cfg, device, "pool")["beauty"]
    finally:
        if old is None:
            del os.environ["RAYTRACER_TPU_NO_FUSED"]
        else:
            os.environ["RAYTRACER_TPU_NO_FUSED"] = old
    _hb(f"pool-render: done, mean={beauty.mean():.4f}")
    return [("smoke_pool_128x72", "pool-render", 0.01, beauty)]


def _check_images(render_fn, device) -> int:
    device = resolve_device(device)
    try:
        images = render_fn(device)
    except RuntimeError as e:
        return _fail(str(e))
    info = device_info(device)
    for name, label, max_frac, img in images:
        err = _check_image(img, name, label, max_frac=max_frac, device=info)
        if err:
            return _fail(err)
    return 0


def stage_fused_fast(device=None) -> int:
    return _check_images(render_fused_fast, device)


def stage_fused_features(device=None) -> int:
    return _check_images(render_fused_features, device)


def stage_pool_render(device=None) -> int:
    return _check_images(render_pool, device)


def _camera_rays(cam, device, n: int = 512):
    """n camera rays of a 128x72 frame at seeded pixels (torch generator
    seed 7; the lanes' streams from seed 8)."""
    from ..core import rng
    from ..models import camera

    px = torch.randint(0, 128 * 72, (n,),
                       generator=torch.Generator().manual_seed(7)).to(device)
    lr = rng.lane_rng(rng.seed_from_int(8), px, 0).with_ctx(0, 0)
    o, d = camera.generate_rays(cam.to(device), lr, px, 128)
    return o.contiguous(), d.contiguous()


def stage_hit_agree(device=None) -> int:
    """K4 against the exact brute-force oracle on 512 camera rays of the
    128x72 showcase, under the reference's budgets (utils/smoke.py:
    339-418): hit flips <= max(2, 1%), winner flips <= max(2, 2.5%), and
    among same-winner rays at most 3% over 5e-3 relative in t and none
    over 5e-2. On the CPU, K4's plain version takes its place."""
    from ..ops import closest_hit, intersect

    device = resolve_device(device)
    scene, cam, _ = _showcase(128, 72)
    scene = scene.to(device)
    n = 512
    o, d = _camera_rays(cam, device, n)
    tmin = 1e-3
    _hb(f"hit-agree: {n} rays, K4 on {device} vs exact brute oracle")
    t, idx, typ = closest_hit.closest_hit_feats(
        intersect.ray_feature_rows(o, d).contiguous(), tmin,
        closest_hit.scan_tables(scene))
    hit_o = intersect.intersect_brute(scene, o, d, tmin)

    tp, idp, typ_p = t.cpu().numpy(), idx.cpu().numpy(), typ.cpu().numpy()
    hp = tp < intersect.T_MAX
    ho = hit_o.hit.cpu().numpy()
    n_hit_flip = int((hp != ho).sum())
    if n_hit_flip > max(2, n // 100):
        bad = np.nonzero(hp != ho)[0][:8]
        return _fail(f"hit-agree: {n_hit_flip}/{n} hit-set mismatches, "
                     f"rays {bad.tolist()} (kernel={hp[bad].tolist()} "
                     f"oracle={ho[bad].tolist()})")
    both = hp & ho
    to = hit_o.t.cpu().numpy()[both]
    ido = hit_o.prim_idx.cpu().numpy()[both]
    tyo = hit_o.prim_type.cpu().numpy()[both]
    same_winner = (idp[both] == ido) & (typ_p[both] == tyo)
    n_winner = int((~same_winner).sum())
    if n_winner > max(2, n // 40):
        return _fail(f"hit-agree: {n_winner}/{n} winner flips exceed the "
                     f"knife-edge budget {max(2, n // 40)}")
    tp_s, to_s = tp[both][same_winner], to[same_winner]
    rel = np.abs(tp_s - to_s) / np.maximum(np.abs(to_s), 1e-3)
    frac_t = float((rel > 5e-3).mean()) if rel.size else 0.0
    if frac_t > 0.03 or (rel.size and rel.max() > 5e-2):
        worst = int(np.argmax(rel))
        return _fail(f"hit-agree: same-winner t drift out of budget "
                     f"(frac>5e-3 = {frac_t:.2%}, max rel = "
                     f"{rel.max():.3g}; worst kernel={tp_s[worst]:.6f} "
                     f"oracle={to_s[worst]:.6f})")
    _hb(f"hit-agree: ok, hits={int(both.sum())}/{n}, hit flips "
        f"{n_hit_flip}, winner flips {n_winner}, frac(rel>5e-3) "
        f"{frac_t:.4f}")
    return 0


def stage_bvh_traverse(device=None) -> int:
    """The BVH traversal against the brute-force oracle on 512 camera rays
    of bvh_stress_scene(n_spheres=9000): equal hit sets, t within
    rtol/atol 2e-4 (utils/smoke.py:420-456)."""
    from ..models import camera, presets
    from ..ops import intersect, traverse

    device = resolve_device(device)
    _hb("bvh-traverse: building 9k-sphere stress scene")
    big = presets.bvh_stress_scene(n_spheres=9000, with_bvh=True)
    if big.bvh is None:
        return _fail("bvh-traverse: the stress scene has no BVH")
    big = big.to(device)
    cam = camera.make_camera(image_width=128, image_height=72, vfov=35.0,
                             lookfrom=(5.0, 6.0, 6.0),
                             lookat=(5.0, 4.0, -12.0))
    o, d = _camera_rays(cam, device)
    _hb(f"bvh-traverse: traversal vs oracle on {device}")
    hit_b = traverse.intersect_bvh(big, o, d, 1e-3)
    hit_o = intersect.intersect_brute(big, o, d, 1e-3)
    hb, ho = hit_b.hit.cpu().numpy(), hit_o.hit.cpu().numpy()
    if not (hb == ho).all():
        bad = np.nonzero(hb != ho)[0][:8]
        return _fail(f"bvh-traverse: hit-set mismatch at rays {bad.tolist()}")
    tb = hit_b.t.cpu().numpy()[hb & ho]
    to = hit_o.t.cpu().numpy()[hb & ho]
    if not np.allclose(tb, to, rtol=2e-4, atol=2e-4):
        return _fail(f"bvh-traverse: t mismatch max|dt|="
                     f"{np.abs(tb - to).max():.3e}")
    _hb(f"bvh-traverse: ok, hits={int((hb & ho).sum())}/{len(hb)}")
    return 0


def run_smoke(device=None) -> int:
    """Every stage on `device` (the card unless the caller asks for the
    CPU; SMOKE_FAST=1: fused-fast only). 0 when all pass, else 1 after
    the first stage that fails."""
    dev = resolve_device(device)
    info = device_info(dev)
    fast = bool(os.environ.get("SMOKE_FAST"))
    _hb(f"device={dev} {info.name} cuda={info.cuda or '-'} torch="
        f"{torch.__version__} mode={'fast' if fast else 'full'}")
    stages = [("fused-fast", stage_fused_fast)]
    if not fast:
        stages += [("fused-features", stage_fused_features),
                   ("pool-render", stage_pool_render),
                   ("hit-agree", stage_hit_agree),
                   ("bvh-traverse", stage_bvh_traverse)]
    for name, fn in stages:
        _hb(f"stage {name}: start")
        rc = fn(dev)
        if rc:
            return rc
        _hb(f"stage {name}: PASS")
    print(f"SMOKE OK: device={dev}{f' ({info.name})' if info.name else ''} "
          f"stages={[n for n, _ in stages]}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; the CUDA kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    try:
        return run_smoke(args.device)
    except RuntimeError as e:
        return _fail(str(e))


if __name__ == "__main__":
    sys.exit(main())
