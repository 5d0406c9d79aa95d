"""Scene generator of the `funnel` configuration: the upstream project's
BVH test world (jarek1992/raytracer_project, scene_management.hpp:206-225,
"sphere's funnel (BVH test)"), as raytracer_project_tpu_torch/models/
presets.py `bvh_stress_scene` builds it: the upstream's spiral of spheres
(radius and height grow with the index fraction, the angle advances 8 rad
a sphere) at n_spheres instead of 64, a ground sphere and a lamp, and
mesh_detail tessellated tori dropped through the funnel's axis.

This file is the benchmark's own copy of that generator and of the
procedural torus it uses (models/assets.py `torus_mesh`, without the
asset-file lookup), so that a later change to the port's presets cannot
change the cell. `build(b, cfg)` drives any builder with the port's
SceneBuilder interface: the harness hands it the port's builder and the
reference's copy of it, so both sides receive the same primitives and
materials.
"""

from __future__ import annotations

import numpy as np


def _grid_mesh(points: np.ndarray):
    """points [NU, NV, 3], wrapped in both directions -> triangle corners
    (v0, v1, v2), each [2 NU NV, 3] (models/assets.py _grid_mesh)."""
    nu, nv = points.shape[:2]
    u0, v0 = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    u1 = (u0 + 1) % nu
    v1 = (v0 + 1) % nv
    p00 = points[u0, v0].reshape(-1, 3)
    p10 = points[u1, v0].reshape(-1, 3)
    p01 = points[u0, v1].reshape(-1, 3)
    p11 = points[u1, v1].reshape(-1, 3)
    return (np.concatenate([p00, p00]), np.concatenate([p10, p11]),
            np.concatenate([p11, p01]))


def torus_mesh(major: float, minor: float, nu: int, nv: int):
    """The procedural torus of models/assets.py `torus_mesh`."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    y = minor * np.sin(vv)
    return _grid_mesh(np.stack([x, y, z], -1))


def build(b, cfg: dict) -> None:
    """Add the funnel world to builder `b` (presets.bvh_stress_scene with
    the configuration's `scene` parameters: n_spheres, mesh_detail, seed)."""
    p = cfg["scene"]
    n_spheres = int(p["n_spheres"])
    rng = np.random.default_rng(int(p["seed"]))
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
        z = -14.0 + radius * np.sin(angle) + 2.0
        g.add_sphere((x, height, z), sphere_radius, white)

    torus = torus_mesh(major=1.2, minor=0.4, nu=96, nv=44)
    for k in range(int(p["mesh_detail"])):
        ang = rng.uniform(0, 2 * np.pi)
        c = np.asarray([5.0 + 2.5 * np.cos(ang), 3.0 + 2.0 * k,
                        -12.0 + 2.5 * np.sin(ang)], np.float32)
        g.add_triangles(torus[0] + c, torus[1] + c, torus[2] + c, white)
