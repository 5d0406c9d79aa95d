"""Procedural assets (twin of raytracer_project_tpu/models/assets.py).

Deterministic numpy generators for the bump maps, the wood texture and the
meshes (teapot, cylinder, torus, torus knot, pyramid, bowl). Real files
take their places when RAYTRACER_TPU_ASSETS points at an asset root laid
out like the reference's assets/ directory: bump_maps/*.jpg,
textures/fine-wood.jpg (read with utils/image_io.load_image, which needs
PIL) and models/<name>.obj.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .obj import Mesh, load_obj

_ASSET_ENV = "RAYTRACER_TPU_ASSETS"


def _asset_path(*parts) -> str | None:
    root = os.environ.get(_ASSET_ENV)
    if not root:
        return None
    p = os.path.join(root, *parts)
    return p if os.path.exists(p) else None


def _try_load_image(*parts) -> np.ndarray | None:
    """The image at <asset root>/<parts> as f32 [H, W, 3], or None."""
    p = _asset_path(*parts)
    if p is None:
        return None
    from ..utils import image_io

    return image_io.load_image(p)


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Tileable smooth value noise in [0, 1], [size, size]."""
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


# Bump maps carry the height in the R channel (material.hpp:43-46).

@functools.lru_cache(maxsize=None)
def wood_bump_map(size: int = 256) -> np.ndarray:
    real = _try_load_image("bump_maps", "wood_bump_map.jpg")
    if real is not None:
        return real
    yy = np.linspace(0, 1, size, endpoint=False)[:, None]
    n = _fbm(size, seed=11, octaves=3)
    rings = 0.5 + 0.5 * np.sin((yy * 14.0 + n * 2.0) * 2.0 * np.pi)
    return _gray_to_rgb(0.3 + 0.7 * rings * (0.7 + 0.3 * n))


@functools.lru_cache(maxsize=None)
def scratches_bump_map(size: int = 256) -> np.ndarray:
    real = _try_load_image("bump_maps", "scratches_bump_map.jpg")
    if real is not None:
        return real
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


@functools.lru_cache(maxsize=None)
def concrete_bump_map(size: int = 256) -> np.ndarray:
    real = _try_load_image("bump_maps", "concrete_bump_map.jpg")
    if real is not None:
        return real
    return _gray_to_rgb(0.2 + 0.8 * _fbm(size, seed=37, octaves=5, base_cells=8))


@functools.lru_cache(maxsize=None)
def water_bump_map(size: int = 256) -> np.ndarray:
    real = _try_load_image("bump_maps", "water_bump_map.jpg")
    if real is not None:
        return real
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    n = _fbm(size, seed=41, octaves=3)
    ripples = (np.sin((x * 6 + n) * 2 * np.pi) + np.sin((y * 5 - n) * 2 * np.pi)
               + np.sin(((x + y) * 4 + 2 * n) * 2 * np.pi))
    return _gray_to_rgb(0.5 + ripples / 6.0)


@functools.lru_cache(maxsize=None)
def fine_wood_texture(size: int = 256) -> np.ndarray:
    real = _try_load_image("textures", "fine-wood.jpg")
    if real is not None:
        return real
    rings = wood_bump_map(size)[..., 0]
    dark = np.array([0.26, 0.13, 0.06], np.float32)
    light = np.array([0.55, 0.33, 0.16], np.float32)
    return dark + (light - dark) * rings[..., None]


def _grid_mesh(points: np.ndarray, wrap_u: bool, wrap_v: bool) -> Mesh:
    """points [NU, NV, 3] -> triangle mesh."""
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

    v0s = np.concatenate([p00.reshape(-1, 3), p00.reshape(-1, 3)])
    v1s = np.concatenate([p10.reshape(-1, 3), p11.reshape(-1, 3)])
    v2s = np.concatenate([p11.reshape(-1, 3), p01.reshape(-1, 3)])
    return Mesh(v0=v0s, v1=v1s, v2=v2s)


def _lathe(profile_rx: np.ndarray, profile_y: np.ndarray, nu: int = 32) -> Mesh:
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    x = profile_rx[None, :] * np.cos(u)[:, None]
    z = profile_rx[None, :] * np.sin(u)[:, None]
    y = np.broadcast_to(profile_y[None, :], x.shape)
    return _grid_mesh(np.stack([x, y, z], -1), True, False)


def _obj_or(name: str, fallback) -> Mesh:
    """<asset root>/models/<name>.obj when it exists and holds triangles,
    else the procedural mesh `fallback()`."""
    p = _asset_path("models", f"{name}.obj")
    if p:
        mesh = load_obj(p)
        if mesh is not None and mesh.count:
            return mesh
    return fallback()


@functools.lru_cache(maxsize=None)
def torus_mesh(major: float = 1.0, minor: float = 0.35, nu: int = 32,
               nv: int = 20) -> Mesh:
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (major + minor * np.cos(vv)) * np.cos(uu)
    z = (major + minor * np.cos(vv)) * np.sin(uu)
    y = minor * np.sin(vv)
    return _obj_or("torus",
                   lambda: _grid_mesh(np.stack([x, y, z], -1), True, True))


@functools.lru_cache(maxsize=None)
def torus_knot_mesh(p: int = 2, q: int = 3, tube: float = 0.22,
                    nu: int = 96, nv: int = 12) -> Mesh:
    def gen():
        t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        r = 2.0 + np.cos(q * t)
        c = np.stack([r * np.cos(p * t), np.sin(q * t), r * np.sin(p * t)], -1)
        # A Frenet-like frame from finite differences.
        tan = np.roll(c, -1, 0) - np.roll(c, 1, 0)
        tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
        n1 = np.cross(tan, np.array([0.0, 1.0, 0.0]))
        n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-9)
        n2 = np.cross(tan, n1)
        ang = np.linspace(0, 2 * np.pi, nv, endpoint=False)
        ring = (np.cos(ang)[None, :, None] * n1[:, None, :]
                + np.sin(ang)[None, :, None] * n2[:, None, :])
        return _grid_mesh(c[:, None, :] + tube * ring, True, True)

    return _obj_or("torus_knot", gen)


@functools.lru_cache(maxsize=None)
def cylinder_mesh(radius: float = 1.0, height: float = 2.0, nu: int = 32) -> Mesh:
    def gen():
        u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
        ring = np.stack([radius * np.cos(u), np.zeros_like(u),
                         radius * np.sin(u)], -1)
        bottom = ring.copy()
        top = ring + np.array([0, height, 0])
        side = _grid_mesh(np.stack([bottom, top], axis=1), True, False)
        # Caps as fans around the center.
        cb = np.array([0.0, 0.0, 0.0])
        ct = np.array([0.0, height, 0.0])
        nb = np.roll(bottom, -1, 0)
        nt = np.roll(top, -1, 0)
        v0 = np.concatenate([side.v0, np.tile(cb, (nu, 1)), np.tile(ct, (nu, 1))])
        v1 = np.concatenate([side.v1, nb, top])
        v2 = np.concatenate([side.v2, bottom, nt])
        return Mesh(v0=v0, v1=v1, v2=v2)

    return _obj_or("cylinder", gen)


@functools.lru_cache(maxsize=None)
def pyramid_mesh(base: float = 2.0, height: float = 2.0) -> Mesh:
    def gen():
        h = base / 2.0
        b = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]],
                     np.float64)
        apex = np.array([0.0, height, 0.0])
        v0 = np.stack([b[0], b[1], b[2], b[3], b[0], b[0]])
        v1 = np.stack([b[1], b[2], b[3], b[0], b[2], b[3]])
        v2 = np.stack([apex, apex, apex, apex, b[1], b[2]])
        return Mesh(v0=v0, v1=v1, v2=v2)

    return _obj_or("pyramid", gen)


@functools.lru_cache(maxsize=None)
def bowl_mesh(radius: float = 1.0, nu: int = 32, nv: int = 12) -> Mesh:
    def gen():
        t = np.linspace(np.pi, np.pi / 2, nv)  # bottom pole to rim
        outer_r = radius * np.abs(np.sin(t))
        outer_y = radius * (np.cos(t) + 1.0)
        inner = 0.85
        rx = np.concatenate([outer_r, outer_r[::-1] * inner])
        y = np.concatenate([outer_y, outer_y[::-1] * inner + 0.15 * radius])
        return _lathe(rx, y, nu)

    return _obj_or("bowl", gen)


@functools.lru_cache(maxsize=None)
def teapot_mesh(nu: int = 32) -> Mesh:
    """Lathed teapot-silhouette body plus a tilted cylinder spout."""
    def gen():
        y = np.array([0.0, 0.05, 0.3, 0.8, 1.2, 1.45, 1.5, 1.62, 1.7],
                     np.float64)
        r = np.array([0.45, 0.62, 0.85, 0.95, 0.75, 0.45, 0.42, 0.18, 0.0],
                     np.float64)
        body = _lathe(r, y, nu)
        spout = cylinder_mesh(0.09, 0.9, 10)
        c, s = np.cos(np.deg2rad(-55)), np.sin(np.deg2rad(-55))
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)
        place = lambda v: v @ rot.T + np.array([0.0, 0.75, 0.8])
        return Mesh(
            v0=np.concatenate([body.v0, place(spout.v0)]),
            v1=np.concatenate([body.v1, place(spout.v1)]),
            v2=np.concatenate([body.v2, place(spout.v2)]),
        )

    return _obj_or("teapot", gen)
