"""The golden render configurations of tests/goldens/ (the reference's
tests/test_goldens.py render_showcase, render_shirley, render_cornell,
render_hdri): each as (scene, camera, environment, RenderConfig) of the
port, chunked as the goldens were made, the check of a render against its
golden, and what the golden writers share. The CPU tests
(tests/test_torch_scene_goldens.py) and the card's tests
(tests/test_torch_cuda.py) render them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
GOLDEN_DIR = REPO / "tests" / "goldens"
NAMES = ("shirley", "cornell", "hdri")
# Every scene golden of tests/goldens/ (the reference's tools/make_goldens.py).
SCENE_GOLDENS = ("showcase",) + NAMES
# The reference's files, which the port's writers never overwrite.
READ_ONLY = (GOLDEN_DIR, REPO / "raytracer_project_tpu")
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
    """(scene, camera, environment, config) of golden `name`: the showcase
    (grid 6) at 64x36 @ 8 spp, depth 6, physical sun; Shirley grid
    5 at 64x36 @ 16 spp, depth 8, solid sky, DoF; the Cornell box with fog
    density 0.002 at 64x64 @ 16 spp, depth 8, black background; Shirley
    grid 3 under the procedural equirect (yaw 0.7, tilt 0.2, roll 0.1) at
    64x36 @ 16 spp, depth 6, DoF 2.0."""
    from ..models import camera, environment, presets
    from ..ops import integrator

    cfg = dict(width=64, height=36, samples_per_pixel=16, max_depth=8,
               env_mode=environment.SOLID_COLOR, wavefront=False, **_OFF)
    if name == "showcase":
        return (presets.showcase_scene(grid=6),
                camera.make_camera(image_width=64, image_height=36, vfov=30.0,
                                   lookfrom=(12.0, 2.5, 6.0),
                                   lookat=(0.0, 1.0, 0.0)),
                environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                             sun_intensity=6.0),
                integrator.RenderConfig(**dict(
                    cfg, samples_per_pixel=8, max_depth=6,
                    env_mode=environment.PHYSICAL_SUN)))
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


def writable_dir(path) -> Path:
    """`path` as a directory for a writer of goldens or weights, created;
    raises ValueError for a path inside tests/goldens/ or the JAX package
    (raytracer_project_tpu/), whose files stay the reference."""
    out = Path(path).resolve()
    for ro in READ_ONLY:
        if out == ro or ro in out.parents:
            raise ValueError(f"refusing to write into {out}: {ro} holds the "
                             f"reference's files, which stay as they are")
    out.mkdir(parents=True, exist_ok=True)
    return out


def write_golden(out: Path, name: str, img: np.ndarray, **extra) -> Path:
    """Write out/<name>.npz (beauty f32 and `extra`) after a finite check,
    and print the image's difference from the committed CPU golden
    tests/goldens/<name>.npz where one exists."""
    img = np.asarray(img, np.float32)
    if not np.isfinite(img).all():
        raise ValueError(f"{name}: non-finite pixels")
    committed = GOLDEN_DIR / f"{name}.npz"
    if committed.exists():
        mean, frac = golden_diff(img, name)
        print(f"{name}: vs committed golden mean|d|={mean:.5f} "
              f"frac(>0.05)={frac:.4f}", flush=True)
    path = Path(out) / f"{name}.npz"
    np.savez_compressed(path, beauty=img, **extra)
    print(f"{name}: {img.shape} mean={img.mean():.4f} -> {path}", flush=True)
    return path
