"""Two-level instancing (twin of raytracer_project_tpu/models/instances.py):
per-mesh BVH reuse and incremental instance moves.

The reference engine builds one BVH per mesh when the asset loads and
reuses it across scene rebuilds (model.hpp:95; build_geometry
re-instantiates transforms around it, scene_management.hpp:113-118).

  MeshAsset       local-space triangles, Morton-ordered once, with a local
                  flat BVH built once and shared by every instance and every
                  rebuild. The local order is also the instance's block
                  order in the global tables, so the closest-hit tiles'
                  AABBs stay tight without a global re-sort.
  InstancedWorld  instances are (mesh, 4x4 affine, material) rows. `build`
                  appends each instance as a contiguous block after the base
                  scene's triangles; `set_transform` + `rebuild` recompute
                  only the moved instances' blocks (vertices, Moller-Trumbore
                  coefficient columns, chunk AABB rows): host work
                  O(moved triangles), counted by `triangles_recomputed`.
  intersect_instanced  the two-level closest hit off the card: the base
                  scene through intersect.intersect, then per instance the
                  ray pulled into mesh space and the shared local BVH
                  traversed (t is affine-invariant when o and d transform
                  together).

A scene built here carries bvh=None: a global BVH would need a full
rebuild per move. Renders read the coefficient tables, and the compact
closest-hit rows of K1 and K4 (ops/closest_hit.py scan_tables) are derived
from them once per render, by fused_step.build_tables (fused pool) or
intersect.hit_tables (chunked integrator); nothing keeps the rows of an
earlier scene, so after `rebuild` the next render builds them once from the
moved tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import T_MAX
from ..ops import intersect as isect_mod
from ..ops.intersect import MM_FINE, Hit
from . import geometry as geom_mod
from .scene import Scene, SceneBuilder

_TRI_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
               "tangent", "mat")


@dataclasses.dataclass
class MeshAsset:
    """Local-space mesh and its BVH, built once (model.hpp:95)."""

    name: str
    v0: np.ndarray       # f64[k, 3] local, Morton-ordered
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    local_scene: Scene   # single-mesh scene in local space, with its BVH

    @property
    def local_bvh(self):
        return self.local_scene.bvh

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class _Instance:
    mesh_id: int
    transform: np.ndarray   # 4x4
    mat_id: int
    start: int = -1         # block offset in the global triangle table
    dirty: bool = True


class InstancedWorld:
    """Instances of reusable mesh BVHs with O(block) incremental moves."""

    def __init__(self):
        self.meshes: list[MeshAsset] = []
        self.instances: list[_Instance] = []
        self.triangles_recomputed = 0   # host work of build/rebuild
        self._base_scene: Scene | None = None
        self._tri_host: dict | None = None      # host copies of tri fields
        self._coeff_host: np.ndarray | None = None
        self._bounds_host: np.ndarray | None = None
        self._scene: Scene | None = None

    # -- assets --------------------------------------------------------------

    def add_mesh(self, v0, v1, v2, n0=None, n1=None, n2=None,
                 name: str = "") -> int:
        """Register local-space triangles: Morton order and BVH, once."""
        v0 = np.atleast_2d(np.asarray(v0, np.float64))
        v1 = np.atleast_2d(np.asarray(v1, np.float64))
        v2 = np.atleast_2d(np.asarray(v2, np.float64))
        flat = np.cross(v1 - v0, v2 - v0)
        flat /= np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
        n0 = flat if n0 is None else np.atleast_2d(np.asarray(n0, np.float64))
        n1 = flat if n1 is None else np.atleast_2d(np.asarray(n1, np.float64))
        n2 = flat if n2 is None else np.atleast_2d(np.asarray(n2, np.float64))

        order = geom_mod.GeometryBuilder.morton_order(
            ((v0 + v1 + v2) / 3.0).astype(np.float32))
        v0, v1, v2 = v0[order], v1[order], v2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]

        b = SceneBuilder()
        m = b.materials.lambertian(f"__blas_{len(self.meshes)}__",
                                   (1.0, 1.0, 1.0))
        b.geometry.add_triangles(v0, v1, v2, m, n0=n0, n1=n1, n2=n2)
        local_scene = b.build(with_bvh=True)
        # The local arrays come from the packed local scene, so an
        # instance's global block rows and the local BVH's triangle rows
        # are in the same order (intersect_instanced maps ids by offset).
        lt = local_scene.triangles
        f64 = lambda x: x.numpy().astype(np.float64)
        lv0 = f64(lt.v0)
        self.meshes.append(MeshAsset(
            name=name or f"mesh{len(self.meshes)}",
            v0=lv0, v1=lv0 + f64(lt.e1), v2=lv0 + f64(lt.e2),
            n0=f64(lt.n0), n1=f64(lt.n1), n2=f64(lt.n2),
            local_scene=local_scene))
        return len(self.meshes) - 1

    def add_obj(self, path: str, target_scale: float = 1.0,
                name: str = "") -> int:
        """Register an OBJ model as a reusable mesh asset (the reference's
        sceneAssetsLoader, scene_management.hpp:29-46: load once,
        instantiate many)."""
        from . import obj as obj_mod

        mesh = obj_mod.load_obj(path)
        if mesh is None:
            raise FileNotFoundError(path)
        mesh = obj_mod.normalize_mesh(mesh, target_scale)
        return self.add_mesh(mesh.v0, mesh.v1, mesh.v2, n0=mesh.n0,
                             n1=mesh.n1, n2=mesh.n2, name=name or path)

    def add_instance(self, mesh_id: int, transform, mat_id: int) -> int:
        self.instances.append(_Instance(
            mesh_id=mesh_id,
            transform=np.asarray(transform, np.float64).reshape(4, 4),
            mat_id=mat_id))
        return len(self.instances) - 1

    def set_transform(self, inst_id: int, transform) -> None:
        """Queue an instance move; `rebuild` applies it."""
        inst = self.instances[inst_id]
        inst.transform = np.asarray(transform, np.float64).reshape(4, 4)
        inst.dirty = True

    # -- build / rebuild ------------------------------------------------------

    def _world_block(self, inst: _Instance):
        """The instance's triangles in world space (the arithmetic of
        GeometryBuilder.add_triangles' baked transforms)."""
        mesh = self.meshes[inst.mesh_id]
        m = inst.transform
        self.triangles_recomputed += mesh.count
        return (*(geom_mod._apply_points(m, v) for v in (mesh.v0, mesh.v1,
                                                         mesh.v2)),
                *(geom_mod._apply_normals(m, n) for n in (mesh.n0, mesh.n1,
                                                          mesh.n2)))

    def _write_block(self, inst: _Instance, block) -> None:
        tri = self._tri_host
        s, k = inst.start, self.meshes[inst.mesh_id].count
        v0, v1, v2, n0, n1, n2 = block
        tri["v0"][s:s + k] = v0
        tri["e1"][s:s + k] = v1 - v0
        tri["e2"][s:s + k] = v2 - v0
        tri["n0"][s:s + k] = n0
        tri["n1"][s:s + k] = n1
        tri["n2"][s:s + k] = n2

    def _triangle_table(self):
        return geom_mod.TriangleTable(
            **{k: torch.as_tensor(v.copy()) for k, v in self._tri_host.items()})

    def build(self, builder: SceneBuilder | None = None) -> Scene:
        """First build: the base scene (materials, textures, other
        geometry) plus one contiguous triangle block per instance."""
        builder = builder or _default_builder()
        base = builder.build(with_bvh=False)
        self._base_scene = base
        nb = base.triangles.count
        start = nb
        for inst in self.instances:
            inst.start = start
            start += self.meshes[inst.mesh_id].count
        total = start

        f32 = np.float32
        t = base.triangles
        self._tri_host = tri = {
            k: np.zeros((total,) + tuple(getattr(t, k).shape[1:]),
                        np.int32 if k == "mat" else f32)
            for k in _TRI_FIELDS}
        for k in _TRI_FIELDS:
            tri[k][:nb] = getattr(t, k).numpy()
        for inst in self.instances:
            self._write_block(inst, self._world_block(inst))
            s, k = inst.start, self.meshes[inst.mesh_id].count
            tri["mat"][s:s + k] = inst.mat_id
            inst.dirty = False

        tri_table = self._triangle_table()
        mm = isect_mod.build_mm_tables(base.spheres, tri_table, base.boxes)
        self._coeff_host = np.array(mm.tri_coeff)
        self._bounds_host = np.array(mm.tri_bounds)
        self._scene = base._replace(triangles=tri_table, mm=mm.to("cpu"),
                                    bvh=None)
        return self._scene

    def rebuild(self) -> Scene:
        """Apply the queued instance moves: O(moved triangles) host work;
        the untouched blocks' rows and coefficient columns are reused as
        they are (the counterpart of the reference's sub-BVH reuse across
        build_geometry calls)."""
        if self._scene is None:
            raise RuntimeError("call build() before rebuild()")
        tri, coeff, bounds = self._tri_host, self._coeff_host, self._bounds_host
        dirty = [i for i in self.instances if i.dirty]
        if not dirty:
            return self._scene
        touched = []
        for inst in dirty:
            s, k = inst.start, self.meshes[inst.mesh_id].count
            self._write_block(inst, self._world_block(inst))
            coeff[:, :, s:s + k] = isect_mod.tri_coeff_block(
                tri["v0"][s:s + k], tri["e1"][s:s + k], tri["e2"][s:s + k])
            touched.append((s, k))
            inst.dirty = False

        # The MM_FINE-wide chunk AABB rows that overlap a moved block.
        n_rows = tri["v0"].shape[0]
        for s, k in touched:
            for c in range(s // MM_FINE, -(-(s + k) // MM_FINE)):
                lo, hi = c * MM_FINE, min((c + 1) * MM_FINE, n_rows)
                va = tri["v0"][lo:hi]
                vb = va + tri["e1"][lo:hi]
                vc = va + tri["e2"][lo:hi]
                if c < bounds.shape[0]:
                    bounds[c, 0:3] = np.minimum(np.minimum(va, vb), vc).min(0)
                    bounds[c, 3:6] = np.maximum(np.maximum(va, vb), vc).max(0)

        mm = self._scene.mm._replace(tri_coeff=torch.as_tensor(coeff.copy()),
                                     tri_bounds=torch.as_tensor(bounds.copy()))
        self._scene = self._scene._replace(triangles=self._triangle_table(),
                                           mm=mm)
        return self._scene


def _default_builder() -> SceneBuilder:
    b = SceneBuilder()
    b.materials.lambertian("__default__", (0.8, 0.8, 0.8))
    return b


def intersect_instanced(world: InstancedWorld, scene: Scene, o, d,
                        tmin: float) -> Hit:
    """Closest hit: the base scene's primitives (intersect.intersect), then
    each instance's local BVH with the ray pulled into mesh space. The hit
    t found in local coordinates is the world t, since o and d transform
    through the same affine map. o, d f32[N, 3] (CPU tensors or arrays)."""
    from ..ops import traverse

    o = torch.as_tensor(np.asarray(o, np.float32))
    d = torch.as_tensor(np.asarray(d, np.float32))
    base = world._base_scene
    hit = isect_mod.intersect(base, o, d, tmin, isect_mod.hit_tables(base))
    best_t = torch.where(hit.hit, hit.t, torch.inf)
    best_idx = hit.prim_idx
    best_type = hit.prim_type
    any_hit = hit.hit

    for inst in world.instances:
        mesh = world.meshes[inst.mesh_id]
        minv = np.linalg.inv(inst.transform)
        a = torch.as_tensor(minv[:3, :3].astype(np.float32))
        t3 = torch.as_tensor(minv[:3, 3].astype(np.float32))
        h = traverse.intersect_bvh(mesh.local_scene, o @ a.T + t3, d @ a.T,
                                   tmin)
        better = h.hit & (h.t < best_t)
        best_t = torch.where(better, h.t, best_t)
        # The instance block shares the local BVH's row order: an offset.
        best_idx = torch.where(better, inst.start + h.prim_idx, best_idx)
        best_type = torch.where(better, isect_mod.PRIM_TRIANGLE, best_type)
        any_hit = any_hit | better

    return Hit(t=torch.where(any_hit, best_t, T_MAX),
               prim_type=best_type.to(torch.int32),
               prim_idx=best_idx.to(torch.int32), hit=any_hit)
