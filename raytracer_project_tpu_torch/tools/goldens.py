"""The golden render configurations of tests/goldens/ past the showcase
(the reference's tests/test_goldens.py render_shirley, render_cornell,
render_hdri): each as (scene, camera, environment, RenderConfig) of the
port, chunked as the goldens were made, and the check of a render against
its golden. The CPU tests (tests/test_torch_scene_goldens.py), the card's
tests (tests/test_torch_cuda.py) and chip_smoke.py all render them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

GOLDEN_DIR = Path(__file__).resolve().parent.parent.parent / "tests" / "goldens"
NAMES = ("shirley", "cornell", "hdri")
_OFF = dict(use_albedo=False, use_normal=False, use_z_depth=False)


def procedural_hdr(h: int = 32, w: int = 64) -> np.ndarray:
    """The goldens' equirect: a sky gradient and one hot 'sun' texel
    block."""
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = (1.0 - v) * np.array([[0.35, 0.55, 1.2]], np.float32) \
        + v * np.array([[0.9, 0.7, 0.5]], np.float32)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    img[h // 4:h // 4 + 2, w // 3:w // 3 + 3] = (40.0, 36.0, 30.0)
    return img


def golden_config(name: str):
    """(scene, camera, environment, config) of golden `name`: Shirley grid
    5 at 64x36 @ 16 spp, depth 8, solid sky, DoF; the Cornell box with fog
    density 0.002 at 64x64 @ 16 spp, depth 8, black background; Shirley
    grid 3 under the procedural equirect (yaw 0.7, tilt 0.2, roll 0.1) at
    64x36 @ 16 spp, depth 6, DoF 2.0."""
    from ..models import camera, environment, presets
    from ..ops import integrator

    cfg = dict(width=64, height=36, samples_per_pixel=16, max_depth=8,
               env_mode=environment.SOLID_COLOR, wavefront=False, **_OFF)
    shirley_cam = dict(image_width=64, image_height=36, vfov=20.0,
                       lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                       focus_dist=10.0)
    if name == "shirley":
        return (presets.shirley_final_scene(grid=5),
                camera.make_camera(defocus_angle=0.6, **shirley_cam),
                environment.make_environment(background_color=(0.7, 0.8, 1.0)),
                integrator.RenderConfig(**cfg))
    if name == "cornell":
        return (presets.cornell_box_scene(with_fog=True, fog_density=0.002),
                camera.make_camera(image_width=64, image_height=64, vfov=40.0,
                                   lookfrom=(278.0, 278.0, -800.0),
                                   lookat=(278.0, 278.0, 0.0)),
                environment.make_environment(background_color=(0.0, 0.0, 0.0)),
                integrator.RenderConfig(**dict(cfg, height=64)))
    if name == "hdri":
        return (presets.shirley_final_scene(grid=3),
                camera.make_camera(defocus_angle=2.0, **shirley_cam),
                environment.make_environment(
                    hdr_image=procedural_hdr(), hdri_rotation=0.7,
                    hdri_tilt=0.2, hdri_roll=0.1),
                integrator.RenderConfig(**dict(
                    cfg, max_depth=6, env_mode=environment.HDR_MAP)))
    raise ValueError(f"no golden config {name!r}")


def golden_diff(img: np.ndarray, name: str) -> tuple[float, float]:
    """(mean |d|, fraction of pixels with a channel over 0.05) of a beauty
    image against tests/goldens/<name>.npz."""
    golden = np.load(GOLDEN_DIR / f"{name}.npz")["beauty"]
    if img.shape != golden.shape:
        raise ValueError(f"image {img.shape}, golden {golden.shape}")
    d = np.abs(img - golden)
    return float(d.mean()), float((d.max(axis=-1) > 0.05).mean())
