"""Render the feature-by-feature parity gallery with the port (twin of the
repository's tools/make_parity_gallery.py).

    python -m raytracer_project_tpu_torch.tools.make_parity_gallery \
        [--out build/parity_torch] [--width 200] [--height 112] \
        [--spp-scale 1.0] [--device cpu]

Writes the reference's 16 PNGs, under its file names and with its
scenes, cameras and sample counts (each count times --spp-scale, at least
1), into --out (default build/parity_torch/; never docs/parity/, which
holds the reference's gallery). PARITY.md describes what each image
should show.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import goldens

DEFAULT_OUT = goldens.REPO / "build" / "parity_torch"
NAMES = ("01_shirley_final.png", "02_cornell.png", "03_showcase.png",
         "04_showcase_albedo.png", "05_showcase_normals.png",
         "06_showcase_zdepth.png", "07_sun_day.png", "08_sun_sunset.png",
         "09_sun_night.png", "10_hdri_rotated.png", "11_fog.png",
         "12_bvh_wireframe.png", "13_post_graded.png",
         "14_post_gamma_only.png", "15_denoise_input_32spp.png",
         "16_denoise_unet_32spp.png")


def main(argv=None) -> list[str]:
    """Render the gallery; returns the paths written."""
    from ..core import colorspace
    from ..models import camera, denoiser_unet, environment, presets
    from ..ops import debugviz, integrator
    from ..ops import post as post_mod
    from ..utils import image_io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--height", type=int, default=112)
    ap.add_argument("--spp-scale", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = integrator.resolve_device(args.device)
    out_dir = goldens.writable_dir(args.out)
    W, H = args.width, args.height
    written = []

    def render(scene, cam, env, mode, spp=24, depth=8, aovs=False, key=0):
        cfg = integrator.RenderConfig(
            width=W, height=H,
            samples_per_pixel=max(1, round(spp * args.spp_scale)),
            max_depth=depth, env_mode=mode, use_albedo=aovs, use_normal=aovs,
            use_z_depth=aovs, wavefront=True)
        return integrator.render(scene, cam, env, key, cfg, device=dev)

    def save_u8(name, u8):
        path = os.path.join(out_dir, name)
        image_io.save_png(path, u8)
        written.append(path)
        print("wrote", name, flush=True)

    def save(name, img_linear):
        save_u8(name, colorspace.to_srgb_u8(torch.clamp(img_linear, min=0)))

    def cam_at(**kw):
        return camera.make_camera(image_width=W, image_height=H, **kw)

    t0 = time.time()
    # 1. Shirley final scene (BASELINE config 1).
    out = render(presets.shirley_final_scene(grid=7),
                 cam_at(vfov=20, lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                        defocus_angle=0.6, focus_dist=10.0),
                 environment.make_environment(), environment.SOLID_COLOR,
                 spp=32)
    save(NAMES[0], out["beauty"])

    # 2. Cornell box GI.
    out = render(presets.cornell_box_scene(),
                 cam_at(vfov=40, lookfrom=(278, 278, -800),
                        lookat=(278, 278, 0)),
                 environment.make_environment(background_color=(0, 0, 0)),
                 environment.SOLID_COLOR, spp=320)
    save(NAMES[1], out["beauty"])

    # 3-6. Showcase hero objects and its AOVs.
    show_cam = cam_at(vfov=30, lookfrom=(12, 2.5, 6), lookat=(0, 1, 0))
    sun_env = environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                           sun_intensity=6.0)
    out = render(presets.showcase_scene(), show_cam, sun_env,
                 environment.PHYSICAL_SUN, spp=32, aovs=True)
    for name, key in zip(NAMES[2:6], ("beauty", "albedo", "normal", "z_depth")):
        save(name, out[key])

    # 7-9. Physical sun at day, sunset and night.
    sphere_scene = presets.shirley_final_scene(grid=2)
    cam2 = cam_at(vfov=26, lookfrom=(13, 2, 3), lookat=(0, 0.6, 0))
    for name, sd in zip(NAMES[6:9], ((0.3, 0.8, 0.2), (0.95, 0.012, 0.2),
                                     (0.5, -0.4, 0.2))):
        env = environment.make_environment(sun_direction=sd, sun_intensity=6.0)
        save(name, render(sphere_scene, cam2, env, environment.PHYSICAL_SUN,
                          spp=24)["beauty"])

    # 10. HDRI equirect with yaw and tilt: a procedural sky gradient and a
    # bright patch, so that the rotation shows.
    yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 2, 128),
                         indexing="ij")
    hdr = np.stack([0.3 + 2.5 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.35) ** 2)
                                       / 0.01),
                    0.4 + 0.3 * yy, 0.7 - 0.3 * yy], -1).astype(np.float32)
    env = environment.make_environment(hdr_image=hdr, hdri_rotation=0.8,
                                       hdri_tilt=0.15)
    save(NAMES[9], render(sphere_scene, cam2, env, environment.HDR_MAP,
                          spp=24)["beauty"])

    # 11. Constant-medium fog.
    save(NAMES[10], render(presets.showcase_scene(use_fog=True,
                                                  fog_density=0.02, grid=8),
                           show_cam, sun_env, environment.PHYSICAL_SUN,
                           spp=24)["beauty"])

    # 12. BVH wireframe debug view.
    wire_cfg = integrator.RenderConfig(width=W, height=H, samples_per_pixel=4,
                                       max_depth=4,
                                       env_mode=environment.SOLID_COLOR)
    wire = debugviz.render_bvh_debug(
        presets.shirley_final_scene(grid=4).to(dev),
        cam_at(vfov=20, lookfrom=(13, 2, 3), lookat=(0, 0, 0)), 0, wire_cfg,
        level=-1, thickness=0.12)
    save(NAMES[11], wire)

    # 13-14. Post chain: graded (ACES, bloom, vignette) and gamma only.
    beauty = render(presets.showcase_scene(grid=8), show_cam, sun_env,
                    environment.PHYSICAL_SUN, spp=24)["beauty"]
    params = post_mod.make_post_params(
        exposure=0.4, bloom_threshold=0.9, bloom_intensity=0.5,
        vignette_intensity=0.65, saturation=1.15, contrast=1.08).to(dev)
    pcfg = post_mod.PostConfig(use_aces=True, use_bloom=True,
                               use_sharpening=True)
    graded = post_mod.update_post_processing(beauty, params, pcfg,
                                             post_mod.PASS_RGB)
    save_u8(NAMES[12], np.clip(graded.cpu().numpy() * 255.99, 0,
                               255).astype(np.uint8))
    save(NAMES[13], beauty)

    # 15-16. The U-Net denoiser (the shipped weights) on a 32 spp Cornell box.
    out = render(presets.cornell_box_scene(),
                 cam_at(vfov=40, lookfrom=(278, 278, -800),
                        lookat=(278, 278, 0)),
                 environment.make_environment(background_color=(0, 0, 0)),
                 environment.SOLID_COLOR, spp=32, aovs=True)
    save(NAMES[14], out["beauty"])
    model = denoiser_unet.load_default(device=dev)
    if model is not None:
        with torch.no_grad():
            save(NAMES[15], model(out["beauty"], out["albedo"], out["normal"]))

    print(f"gallery done in {time.time() - t0:.0f}s", flush=True)
    return written


if __name__ == "__main__":
    main()
    sys.exit(0)
