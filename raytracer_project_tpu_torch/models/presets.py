"""Preset scenes (twin of raytracer_project_tpu/models/presets.py, subset).

`load_reference_materials` reproduces the reference's material library
(scene_management.hpp:49-100) and `showcase_scene` its showcase world
(:103-236), the scene the main path renders. Randomized placement uses a
seeded numpy Generator, so the port builds the same tables as the
reference package from the same seed. The other presets wait (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from . import geometry
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


def showcase_scene(seed: int = 3, with_bvh: bool = False, use_fog: bool = False,
                   fog_density: float = 0.01, fog_color=(0.8, 0.85, 0.9),
                   with_meshes: bool = True, grid: int = 15) -> Scene:
    """The reference's showcase world (scene_management.hpp:103-236):
    checker-mirror ground sphere, hero objects (glass teapot mesh, scratched
    mirror, scratched gold, bumpy wood, foggy-glass cube), and a
    `2*grid x 2*grid` randomized field of neon cubes / glass spheres /
    regular cubes+spheres with the 25/30/45 distribution; use_fog adds the
    reference's fog sphere (radius 50 around the origin).

    with_bvh is accepted for the reference's signature; the port raises
    NotImplementedError for it until the BVH lands (ROADMAP)."""
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


