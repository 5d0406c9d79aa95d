"""Wavefront OBJ meshes (twin of raytracer_project_tpu/models/obj.py).

The reference engine's TinyObjLoader-backed `model` (model.hpp:12-103):
parse vertices, normals and faces (`parse_obj`, `load_obj`), centre the
model with its bottom at y = 0 and scale it (`normalize_mesh`), and append
its triangles with per-vertex normals, flat when the file has none
(`add_mesh`).
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


def parse_obj(text: str) -> Mesh:
    """Minimal OBJ parser: v / vn / f records, polygon fan triangulation.
    Handles the `f v`, `f v//vn` and `f v/vt/vn` index forms and negative
    indices; normals only when every face corner names one."""
    verts: list[list[float]] = []
    normals: list[list[float]] = []
    tri_v: list[tuple[int, int, int]] = []
    tri_n: list[tuple[int, int, int]] = []

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag == "f":
            corners = []
            for spec in parts[1:]:
                fields = spec.split("/")
                vi = int(fields[0])
                vi = vi - 1 if vi > 0 else len(verts) + vi
                ni = -1
                if len(fields) >= 3 and fields[2]:
                    ni = int(fields[2])
                    ni = ni - 1 if ni > 0 else len(normals) + ni
                corners.append((vi, ni))
            for k in range(1, len(corners) - 1):   # fan triangulation
                tri_v.append((corners[0][0], corners[k][0], corners[k + 1][0]))
                tri_n.append((corners[0][1], corners[k][1], corners[k + 1][1]))

    v = np.asarray(verts, np.float64)
    iv = np.asarray(tri_v, np.int64).reshape(-1, 3)
    v0, v1, v2 = v[iv[:, 0]], v[iv[:, 1]], v[iv[:, 2]]

    n0 = n1 = n2 = None
    if normals and all(n[0] >= 0 for n in tri_n):
        nn = np.asarray(normals, np.float64)
        inn = np.asarray(tri_n, np.int64).reshape(-1, 3)
        n0, n1, n2 = nn[inn[:, 0]], nn[inn[:, 1]], nn[inn[:, 2]]

    return Mesh(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2)


def load_obj(path: str) -> Mesh | None:
    """Load an .obj file; None when it cannot be read (the reference
    engine's empty-model fallback, model.hpp:18-21). The native parser
    (native/, the TinyObjLoader role) reads it when the library builds;
    `parse_obj` gives the same mesh otherwise."""
    from .. import native

    res = native.parse_obj(path)
    if res is not None:
        return Mesh(**res)
    try:
        with open(path) as f:
            return parse_obj(f.read())
    except OSError:
        return None


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
