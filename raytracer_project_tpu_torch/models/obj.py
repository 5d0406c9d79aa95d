"""Triangle meshes (twin of raytracer_project_tpu/models/obj.py, subset).

`Mesh`, `normalize_mesh` and `add_mesh`; reading OBJ files waits for a
later slice (the showcase's teapot is procedural, models/assets.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Triangle soup: vertices of each corner + optional per-corner normals."""

    v0: np.ndarray  # [T,3]
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray | None = None
    n1: np.ndarray | None = None
    n2: np.ndarray | None = None

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def normalize_mesh(mesh: Mesh, target_scale: float = 1.0) -> Mesh:
    """Center XZ at origin, bottom at y=0, uniform scale (model.hpp:23-53)."""
    allv = np.concatenate([mesh.v0, mesh.v1, mesh.v2])
    mn = allv.min(axis=0)
    mx = allv.max(axis=0)
    offset = np.array([(mn[0] + mx[0]) / 2.0, mn[1], (mn[2] + mx[2]) / 2.0])
    f = lambda x: (x - offset) * target_scale
    return Mesh(
        v0=f(mesh.v0), v1=f(mesh.v1), v2=f(mesh.v2),
        n0=mesh.n0, n1=mesh.n1, n2=mesh.n2,
    )


def add_mesh(builder, mesh: Mesh, mat_id: int, transform=None,
             target_scale: float | None = None) -> None:
    """Append a mesh's triangles to a GeometryBuilder (model.hpp:56-92:
    per-vertex normals when present, flat shading otherwise)."""
    if target_scale is not None:
        mesh = normalize_mesh(mesh, target_scale)
    builder.add_triangles(
        v0=mesh.v0, v1=mesh.v1, v2=mesh.v2,
        n0=mesh.n0, n1=mesh.n1, n2=mesh.n2,
        mat_id=mat_id, transform=transform,
    )
