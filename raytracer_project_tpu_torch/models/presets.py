"""Preset scenes (twin of raytracer_project_tpu/models/presets.py): the
repository's render configurations (BASELINE.json).

`load_reference_materials` reproduces the reference's material library
(scene_management.hpp:49-100) and `showcase_scene` its showcase world
(:103-236), the scene the main path renders; `shirley_final_scene` is the
classic RTiOW final scene (configs 1 and 4), `cornell_box_scene` config 2
and `bvh_stress_scene` the sphere funnel with tori (the BVH stress world).
Randomized placement uses a seeded numpy Generator, so the port builds the
same tables as the reference package from the same seed.
"""

from __future__ import annotations

import numpy as np

from . import geometry
from .materials import METAL, MaterialSpec
from .scene import Scene, SceneBuilder


def load_reference_materials(b: SceneBuilder, rng: np.random.Generator) -> None:
    """Register the reference's ~35 named materials
    (scene_management.hpp:49-100). Bump and image texture slots resolve
    to the procedural assets (models/assets.py)."""
    from . import assets

    m = b.materials
    t = b.textures

    wood_bump = t.add_image(assets.wood_bump_map())
    scratches_bump = t.add_image(assets.scratches_bump_map())
    concrete_bump = t.add_image(assets.concrete_bump_map())
    water_bump = t.add_image(assets.water_bump_map())
    wood_tex = t.add_image(assets.fine_wood_texture())

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


def shirley_final_scene(seed: int = 7, with_bvh: bool = True,
                        grid: int = 11) -> Scene:
    """RTiOW 'final scene': checkered ground, random small spheres, three
    hero spheres (BASELINE.json config 1). `grid`=11 gives the classic
    -11..11 layout (~480 spheres)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.materials

    ground_tex = b.textures.add_checker(0.32, even=(0.9, 0.9, 0.9),
                                        odd=(0.2, 0.3, 0.1))
    ground = m.lambertian("ground", texture_id=ground_tex)
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    glass = m.dielectric("glass", 1.5)
    for a in range(-grid, grid):
        for bb in range(-grid, grid):
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            roll = rng.random()
            if roll < 0.8:
                albedo = rng.random(3) * rng.random(3)
                mid = m.add_anonymous(MaterialSpec(0, tuple(albedo)))
            elif roll < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                mid = m.add_anonymous(MaterialSpec(METAL, tuple(albedo), fuzz))
            else:
                mid = glass
            b.geometry.add_sphere(center, 0.2, mid)

    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, glass)
    brown = m.lambertian("hero_brown", (0.4, 0.2, 0.1))
    b.geometry.add_sphere((-4.0, 1.0, 0.0), 1.0, brown)
    silver = m.metal("hero_silver", (0.7, 0.6, 0.5), 0.0)
    b.geometry.add_sphere((4.0, 1.0, 0.0), 1.0, silver)

    return b.build(with_bvh=with_bvh)


def showcase_scene(seed: int = 3, with_bvh: bool = True, use_fog: bool = False,
                   fog_density: float = 0.01, fog_color=(0.8, 0.85, 0.9),
                   with_meshes: bool = True, grid: int = 15) -> Scene:
    """The reference's showcase world (scene_management.hpp:103-236):
    checker-mirror ground sphere, hero objects (glass teapot mesh, scratched
    mirror, scratched gold, bumpy wood, foggy-glass cube), and a
    `2*grid x 2*grid` randomized field of neon cubes / glass spheres /
    regular cubes+spheres with the 25/30/45 distribution; use_fog adds the
    reference's fog sphere (radius 50 around the origin). with_bvh builds
    the scene's BVH (ops/bvh.py); at 1,454 primitives the showcase stays
    below BVH_MIN_PRIMS, so the BVH changes no route."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    load_reference_materials(b, rng)
    m = b.materials
    g = b.geometry

    # 1. floor (scene_management.hpp:107-109)
    g.add_sphere((0.0, -1000.0, 0.0), 1000.0, m.get("reflective_checker_mat"))

    # 2. hero objects (:111-134)
    if with_meshes:
        from . import assets, obj

        teapot = assets.teapot_mesh()
        xform = geometry.compose(
            geometry.translate((0.0, 1.0, -2.5)),
            geometry.rotate_y(30.0),
            geometry.rotate_x(-90.0),
        )
        obj.add_mesh(g, teapot, m.get("glass"), transform=xform, target_scale=0.4)

    g.add_sphere((0.0, 1.0, 0.0), 1.0, m.get("scratched_mirror"))
    g.add_sphere((3.0, 0.5, -1.0), 0.5, m.get("scratched_gold_mat"))
    g.add_sphere((3.0, 0.5, 1.0), 0.5, m.get("wood_bumpy_texture"))
    g.add_cube((0.0, 0.0, 0.0), m.get("foggy_glass"),
               transform=geometry.translate((0.0, 1.0, 2.5)))

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
                xform = geometry.compose(
                    geometry.translate(center),
                    geometry.rotate_y(rng.uniform(0.0, 90.0)),
                    geometry.scale(sc),
                )
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
                    xform = geometry.compose(
                        geometry.translate(center),
                        geometry.rotate_y(rng.uniform(0.0, 90.0)),
                        geometry.scale(s),
                    )
                    g.add_box((-0.2, -0.2, -0.2), (0.2, 0.2, 0.2), m.get(name),
                              transform=xform)

    # 4. environmental fog (scene_management.hpp:227-234).
    if use_fog:
        b.add_fog_sphere((0.0, 0.0, 0.0), 50.0, fog_density, fog_color)

    return b.build(with_bvh=with_bvh)


def cornell_box_scene(with_bvh: bool = True, with_fog: bool = False,
                      fog_density: float = 0.01) -> Scene:
    """Cornell-style box from boxes + emissive ceiling light + optional
    constant-medium fog (BASELINE.json config 2)."""
    b = SceneBuilder()
    m = b.materials
    g = b.geometry

    red = m.lambertian("red", (0.65, 0.05, 0.05))
    white = m.lambertian("white", (0.73, 0.73, 0.73))
    green = m.lambertian("green", (0.12, 0.45, 0.15))
    light = m.diffuse_light("light", (15.0, 15.0, 15.0))

    s = 555.0
    th = 1.0  # wall thickness
    g.add_box((-th, 0, 0), (0, s, s), green)        # left
    g.add_box((s, 0, 0), (s + th, s, s), red)       # right
    g.add_box((0, -th, 0), (s, 0, s), white)        # floor
    g.add_box((0, s, 0), (s, s + th, s), white)     # ceiling
    g.add_box((0, 0, s), (s, s, s + th), white)     # back
    g.add_box((213, s - 0.5, 227), (343, s, 332), light)  # ceiling light

    # Tall and short boxes.
    g.add_box((-82.5, 0, -82.5), (82.5, 330, 82.5), white,
              transform=geometry.compose(
                  geometry.translate((347.5, 0.0, 377.5)),
                  geometry.rotate_y(15.0)))
    g.add_box((-82.5, 0, -82.5), (82.5, 165, 82.5), white,
              transform=geometry.compose(
                  geometry.translate((212.5, 0.0, 147.5)),
                  geometry.rotate_y(-18.0)))

    if with_fog:
        b.add_fog_box((0, 0, 0), (s, s, s), fog_density, (1.0, 1.0, 1.0))
    return b.build(with_bvh=with_bvh)


def bvh_stress_scene(n_spheres: int = 4096, mesh_detail: int = 0,
                     with_bvh: bool = True, seed: int = 9) -> Scene:
    """Sphere-funnel BVH stress world: the reference keeps this scene
    commented out in its scene file as the acceleration-structure torture
    test (scene_management.hpp:206-225, "sphere's funnel (BVH test)"),
    scaled here by n_spheres (the reference's 64 at the same spiral law:
    radius and height grow with the index fraction, the angle advances
    8 rad per sphere).

    mesh_detail > 0 also drops that many densely tessellated tori (8,448
    triangles each) through the funnel axis, taking the primitive count
    well past BVH_MIN_PRIMS."""
    from . import assets

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.materials
    g = b.geometry
    white = m.lambertian("white_diffuse", (0.73, 0.73, 0.73))
    ground = m.lambertian("ground", (0.5, 0.5, 0.5))
    lamp = m.diffuse_light("lamp", (6.0, 6.0, 6.0))

    g.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    g.add_sphere((0.0, 22.0, -8.0), 3.0, lamp)

    sphere_radius = 0.3
    for i in range(n_spheres):
        fraction = i / n_spheres
        radius = 5.0 * fraction
        angle = i * 8.0
        height = sphere_radius + fraction * 10.0
        x = radius * np.cos(angle) + 5.0
        y = height
        z = -14.0 + radius * np.sin(angle) + 2.0
        g.add_sphere((x, y, z), sphere_radius, white)

    for k in range(mesh_detail):
        mesh = assets.torus_mesh(major=1.2, minor=0.4, nu=96, nv=44)
        ang = rng.uniform(0, 2 * np.pi)
        c = np.asarray([5.0 + 2.5 * np.cos(ang), 3.0 + 2.0 * k,
                        -12.0 + 2.5 * np.sin(ang)], np.float32)
        g.add_triangles(mesh.v0 + c, mesh.v1 + c, mesh.v2 + c, white)

    return b.build(with_bvh=with_bvh)
