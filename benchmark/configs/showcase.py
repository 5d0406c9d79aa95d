"""Scene generator of the `showcase` configuration: the upstream project's
showcase world (jarek1992/raytracer_project, scene_management.hpp:49-236),
as raytracer_project_tpu_torch/models/presets.py `showcase_scene` builds it.

This file is the benchmark's own copy of that generator, of the procedural
assets it uses (models/assets.py: the bump maps, the wood texture, the
lathed teapot) and of the host transforms (models/geometry.py), so that a
later change to the port's presets cannot change the cell. `build(b, cfg)`
drives any builder with the port's SceneBuilder interface: the harness
hands it the port's builder and the reference's copy of it, so both sides
receive the same primitives, materials and textures.
"""

from __future__ import annotations

import numpy as np

# -- host transforms (models/geometry.py) -----------------------------------


def translate(offset) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(offset, np.float64)
    return m


def _rot(axis: int, radians: float) -> np.ndarray:
    c, s = np.cos(radians), np.sin(radians)
    m = np.eye(4, dtype=np.float64)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


def rotate_x(degrees: float) -> np.ndarray:
    return _rot(0, np.deg2rad(degrees))


def rotate_y(degrees: float) -> np.ndarray:
    return _rot(1, np.deg2rad(degrees))


def scale(factors) -> np.ndarray:
    f = np.asarray(factors, np.float64)
    if f.ndim == 0:
        f = np.full(3, float(f))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = f
    return m


def compose(*mats) -> np.ndarray:
    """compose(A, B, C) applies C first, then B, then A."""
    out = np.eye(4, dtype=np.float64)
    for m in mats:
        out = out @ m
    return out


# -- procedural assets (models/assets.py) -----------------------------------


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    grid = rng.random((cells, cells)).astype(np.float32)
    y = np.linspace(0, cells, size, endpoint=False)
    x = np.linspace(0, cells, size, endpoint=False)
    yi = np.floor(y).astype(int) % cells
    xi = np.floor(x).astype(int) % cells
    yf = (y - np.floor(y))[:, None]
    xf = (x - np.floor(x))[None, :]
    sy = yf * yf * (3 - 2 * yf)
    sx = xf * xf * (3 - 2 * xf)
    g00 = grid[np.ix_(yi, xi)]
    g01 = grid[np.ix_(yi, (xi + 1) % cells)]
    g10 = grid[np.ix_((yi + 1) % cells, xi)]
    g11 = grid[np.ix_((yi + 1) % cells, (xi + 1) % cells)]
    top = g00 * (1 - sx) + g01 * sx
    bot = g10 * (1 - sx) + g11 * sx
    return top * (1 - sy) + bot * sy


def _fbm(size: int, seed: int, octaves: int = 4, base_cells: int = 4) -> np.ndarray:
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        out += amp * _value_noise(size, base_cells * (2 ** o), seed + o)
        total += amp
        amp *= 0.5
    return out / total


def _gray_to_rgb(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[..., None], 3, axis=-1).astype(np.float32)


def wood_bump_map(size: int = 256) -> np.ndarray:
    yy = np.linspace(0, 1, size, endpoint=False)[:, None]
    n = _fbm(size, seed=11, octaves=3)
    rings = 0.5 + 0.5 * np.sin((yy * 14.0 + n * 2.0) * 2.0 * np.pi)
    return _gray_to_rgb(0.3 + 0.7 * rings * (0.7 + 0.3 * n))


def scratches_bump_map(size: int = 256) -> np.ndarray:
    rng = np.random.default_rng(23)
    img = np.full((size, size), 0.5, np.float32)
    for _ in range(180):
        x0, y0 = rng.integers(0, size, 2)
        angle = rng.uniform(0, np.pi)
        length = rng.integers(size // 8, size // 2)
        depth = rng.uniform(0.2, 0.5)
        t = np.arange(length)
        xs = (x0 + t * np.cos(angle)).astype(int) % size
        ys = (y0 + t * np.sin(angle)).astype(int) % size
        img[ys, xs] -= depth * np.exp(-((t / length - 0.5) ** 2) * 8)
    return _gray_to_rgb(np.clip(img, 0.0, 1.0))


def concrete_bump_map(size: int = 256) -> np.ndarray:
    return _gray_to_rgb(0.2 + 0.8 * _fbm(size, seed=37, octaves=5, base_cells=8))


def water_bump_map(size: int = 256) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    n = _fbm(size, seed=41, octaves=3)
    ripples = (np.sin((x * 6 + n) * 2 * np.pi) + np.sin((y * 5 - n) * 2 * np.pi)
               + np.sin(((x + y) * 4 + 2 * n) * 2 * np.pi))
    return _gray_to_rgb(0.5 + ripples / 6.0)


def fine_wood_texture(size: int = 256) -> np.ndarray:
    rings = wood_bump_map(size)[..., 0]
    dark = np.array([0.26, 0.13, 0.06], np.float32)
    light = np.array([0.55, 0.33, 0.16], np.float32)
    return dark + (light - dark) * rings[..., None]


def _grid_mesh(points: np.ndarray, wrap_u: bool, wrap_v: bool):
    """points [NU, NV, 3] -> triangle corners (v0, v1, v2), each [T, 3]."""
    nu, nv = points.shape[:2]
    iu = np.arange(nu if wrap_u else nu - 1)
    iv = np.arange(nv if wrap_v else nv - 1)
    u0, v0 = np.meshgrid(iu, iv, indexing="ij")
    u1 = (u0 + 1) % nu
    v1 = (v0 + 1) % nv
    p00 = points[u0, v0]
    p10 = points[u1, v0]
    p01 = points[u0, v1]
    p11 = points[u1, v1]
    return (np.concatenate([p00.reshape(-1, 3), p00.reshape(-1, 3)]),
            np.concatenate([p10.reshape(-1, 3), p11.reshape(-1, 3)]),
            np.concatenate([p11.reshape(-1, 3), p01.reshape(-1, 3)]))


def _lathe(profile_rx: np.ndarray, profile_y: np.ndarray, nu: int = 32):
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    x = profile_rx[None, :] * np.cos(u)[:, None]
    z = profile_rx[None, :] * np.sin(u)[:, None]
    y = np.broadcast_to(profile_y[None, :], x.shape)
    return _grid_mesh(np.stack([x, y, z], -1), True, False)


def _cylinder(radius: float, height: float, nu: int):
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    ring = np.stack([radius * np.cos(u), np.zeros_like(u),
                     radius * np.sin(u)], -1)
    bottom = ring.copy()
    top = ring + np.array([0, height, 0])
    s0, s1, s2 = _grid_mesh(np.stack([bottom, top], axis=1), True, False)
    cb = np.array([0.0, 0.0, 0.0])
    ct = np.array([0.0, height, 0.0])
    nb = np.roll(bottom, -1, 0)
    nt = np.roll(top, -1, 0)
    return (np.concatenate([s0, np.tile(cb, (nu, 1)), np.tile(ct, (nu, 1))]),
            np.concatenate([s1, nb, top]),
            np.concatenate([s2, bottom, nt]))


def teapot_mesh(nu: int = 32):
    """Lathed teapot-silhouette body plus a tilted cylinder spout."""
    y = np.array([0.0, 0.05, 0.3, 0.8, 1.2, 1.45, 1.5, 1.62, 1.7], np.float64)
    r = np.array([0.45, 0.62, 0.85, 0.95, 0.75, 0.45, 0.42, 0.18, 0.0],
                 np.float64)
    body = _lathe(r, y, nu)
    spout = _cylinder(0.09, 0.9, 10)
    c, s = np.cos(np.deg2rad(-55)), np.sin(np.deg2rad(-55))
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
    place = lambda v: v @ rot.T + np.array([0.0, 0.75, 0.8])
    return tuple(np.concatenate([b, place(p)]) for b, p in zip(body, spout))


def normalize_mesh(corners, target_scale: float):
    """Center XZ at the origin, bottom at y = 0, uniform scale
    (models/obj.py normalize_mesh, model.hpp:23-53)."""
    allv = np.concatenate(corners)
    mn = allv.min(axis=0)
    mx = allv.max(axis=0)
    offset = np.array([(mn[0] + mx[0]) / 2.0, mn[1], (mn[2] + mx[2]) / 2.0])
    return tuple((v - offset) * target_scale for v in corners)


# -- the world (models/presets.py) ------------------------------------------


def load_reference_materials(b, rng: np.random.Generator) -> None:
    """The reference's ~35 named materials (scene_management.hpp:49-100)."""
    m = b.materials
    t = b.textures

    wood_bump = t.add_image(wood_bump_map())
    scratches_bump = t.add_image(scratches_bump_map())
    concrete_bump = t.add_image(concrete_bump_map())
    water_bump = t.add_image(water_bump_map())
    wood_tex = t.add_image(fine_wood_texture())

    m.dielectric("water", 1.33, bump_id=water_bump, bump_strength=0.8)
    m.dielectric("turquoise_water", 1.33, (0.85, 1.0, 0.98), bump_id=water_bump,
                 bump_strength=2.0)
    m.lambertian("red_diffuse", (0.8, 0.1, 0.1))
    m.lambertian("white_diffuse", (1.0, 1.0, 1.0))
    m.metal("copper", (0.95, 0.64, 0.54), 0.0)
    m.metal("rough_copper", (0.89, 0.58, 0.51), 0.2)
    m.metal("rough_gold", (1.0, 0.84, 0.0), 0.15)
    m.lambertian("light_blue_diffuse", (0.1, 0.4, 0.9))
    m.lambertian("white_diffuse", (0.9, 0.9, 0.9))  # overwrite, as reference
    m.lambertian("black_diffuse", (0.1, 0.1, 0.1))
    m.lambertian("wood_texture", texture_id=wood_tex)
    m.lambertian("wood_bumpy_texture", texture_id=wood_tex, bump_id=wood_bump,
                 bump_strength=8.0)
    m.metal("gold_mat", (1.0, 0.8, 0.4), 0.0)
    m.metal("scratched_gold_mat", (1.0, 0.8, 0.4), 0.0, bump_id=scratches_bump,
            bump_strength=-1.0)
    m.metal("mirror", (1.0, 1.0, 1.0), 0.0)
    m.metal("scratched_mirror", (1.0, 1.0, 1.0), 0.0, bump_id=scratches_bump,
            bump_strength=1.0)
    m.metal("brushed_aluminium", (1.0, 1.0, 1.0), 0.25)
    m.lambertian("black_diffuse", (0.05, 0.05, 0.05))  # overwrite, as reference
    m.metal("white_metal", (1.0, 1.0, 1.0), 0.7)
    m.metal("white_metal_bump", (0.9, 0.9, 0.9), 0.6, bump_id=concrete_bump,
            bump_strength=2.0)
    checker_tex = t.add_checker(0.5, even=(0.9, 0.9, 0.9), odd=(0.2, 0.3, 0.1))
    m.lambertian("checker_texture", texture_id=checker_tex)
    m.dielectric("glass_bubble", 1.0 / 1.5)
    m.dielectric("glass", 1.5)
    m.dielectric("foggy_glass", 1.5, bump_id=concrete_bump, bump_strength=0.02)
    m.metal("pure_mirror", (1.0, 1.0, 1.0), 0.0)
    m.lambertian("random_diffuse", tuple(rng.random(3) * rng.random(3)))
    m.diffuse_light("random_neon_light", tuple(rng.uniform(0.1, 1.0, 3) * 1.5))
    m.diffuse_light("neon_pink", (3.0, 0.0, 1.5))
    m.diffuse_light("neon_blue", (0.0, 2.0, 4.0))
    m.diffuse_light("neon_green", (0.4, 4.0, 0.4))
    m.diffuse_light("neon_yellow", (6.0, 4.8, 0.0))
    m.diffuse_light("neon_white", (6.0, 6.0, 6.0))
    m.diffuse_light("neon_red", (6.0, 0.6, 0.6))
    m.diffuse_light("ceiling_emissive", (5.0, 0.0, 2.5))
    refl_checker = t.add_checker(0.5, even=(0.9, 0.9, 0.9), odd=(0.1, 0.1, 0.1))
    m.metal("reflective_checker_mat", texture_id=refl_checker, fuzz=0.02)
    checker1 = t.add_checker(0.5, even=(0.9, 0.9, 0.9), odd=(0.1, 0.1, 0.1))
    m.metal("checker_mat", texture_id=checker1, fuzz=0.95)


def build(b, cfg: dict) -> None:
    """Add the showcase world to builder `b` (presets.showcase_scene with
    the configuration's `scene` parameters: seed, grid, meshes, no fog)."""
    params = cfg["scene"]
    grid = int(params["grid"])
    rng = np.random.default_rng(int(params["seed"]))
    load_reference_materials(b, rng)
    m = b.materials
    g = b.geometry

    # 1. floor (scene_management.hpp:107-109)
    g.add_sphere((0.0, -1000.0, 0.0), 1000.0, m.get("reflective_checker_mat"))

    # 2. hero objects (:111-134)
    if params["with_meshes"]:
        v0, v1, v2 = normalize_mesh(teapot_mesh(), 0.4)
        xform = compose(translate((0.0, 1.0, -2.5)), rotate_y(30.0),
                        rotate_x(-90.0))
        g.add_triangles(v0=v0, v1=v1, v2=v2, mat_id=m.get("glass"),
                        transform=xform)
    g.add_sphere((0.0, 1.0, 0.0), 1.0, m.get("scratched_mirror"))
    g.add_sphere((3.0, 0.5, -1.0), 0.5, m.get("scratched_gold_mat"))
    g.add_sphere((3.0, 0.5, 1.0), 0.5, m.get("wood_bumpy_texture"))
    g.add_cube((0.0, 0.0, 0.0), m.get("foggy_glass"),
               transform=translate((0.0, 1.0, 2.5)))

    # 3. randomized field (:136-204)
    neon_mats = m.get_emissive_names()
    regular_mats = m.get_regular_names()
    for a in range(-grid, grid):
        for bb in range(-grid, grid):
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            dice = rng.random()
            if dice < 0.25 and neon_mats:
                name = neon_mats[rng.integers(0, len(neon_mats))]
                sc = (0.4, rng.uniform(1.5, 4.5), 0.4)
                xform = compose(translate(center),
                                rotate_y(rng.uniform(0.0, 90.0)), scale(sc))
                g.add_box((-0.2, -0.2, -0.2), (0.2, 0.2, 0.2), m.get(name),
                          transform=xform)
            elif dice < 0.55:
                name = "glass" if rng.random() < 0.7 else "glass_bubble"
                s = rng.uniform(0.5, 1.0)
                g.add_sphere(center, 0.2 * s, m.get(name))
            else:
                name = regular_mats[rng.integers(0, len(regular_mats))]
                s = rng.uniform(0.8, 1.2)
                if rng.random() < 0.5:
                    g.add_sphere(center, 0.2 * s, m.get(name))
                else:
                    xform = compose(translate(center),
                                    rotate_y(rng.uniform(0.0, 90.0)), scale(s))
                    g.add_box((-0.2, -0.2, -0.2), (0.2, 0.2, 0.2), m.get(name),
                              transform=xform)
