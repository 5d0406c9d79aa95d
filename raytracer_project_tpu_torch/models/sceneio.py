"""Declarative JSON scene files (twin of
raytracer_project_tpu/models/sceneio.py): load and save full render setups.

A scene is one JSON document of materials, objects, environment, camera and
render settings (schema below; every section optional). The reference
engine compiles its scene into the binary (scene_management.hpp:49-236).

{
  "textures":  {"name": {"type": "checker", "scale": 0.32,
                          "even": [..], "odd": [..]}
                | {"type": "image", "path": "tex.png"}},
  "materials": {"name": {"type": "lambertian|metal|dielectric|
                          diffuse_light|isotropic", "albedo": [r,g,b],
                          "fuzz": 0.1, "ior": 1.5, "emit": [r,g,b],
                          "texture": "texname", "bump": "texname",
                          "bump_strength": 1.0}},
  "objects":   [{"type": "sphere", "center": [..], "radius": r,
                  "material": "name", "transform": [...]},
                {"type": "box", "min": [..], "max": [..], ...},
                {"type": "cube", ...},
                {"type": "mesh", "path": "m.obj", "scale": 2.0, ...},
                {"type": "fog_sphere", "center": [..], "radius": r,
                  "density": d, "color": [..]},
                {"type": "fog_box", "min": [..], "max": [..], ...}],
  "environment": {"mode": "sun|hdr|solid", ...make_environment kwargs,
                  "hdr_path": "sky.hdr",
                  "astronomical": {"latitude": 50.0, "day": 172,
                                    "hour": 14.5}},
  "camera":    {...make_camera kwargs},
  "render":    {...RenderConfig kwargs}
}

Transforms are a list applied left to right (innermost first), each a
one-key dict: {"translate": [x,y,z]}, {"rotate_x": deg}, {"rotate_y": deg},
{"rotate_y_radians": rad} (the reference's quirk, rotate_y.hpp:9 against
scene_management.hpp:116), {"rotate_z": deg}, {"scale": [x,y,z] | s}.

Image texture paths and "hdr_path" resolve against the document's
directory: an image that does not load becomes the cyan missing-texture
sentinel (texture.hpp:52-54), and an HDR map that does not load is looked
up by name under the asset root (environment.load_hdr_by_name), else black
(environment.hpp:64-68).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..ops.integrator import RenderConfig
from . import environment as env_mod
from . import geometry, obj as obj_mod
from .camera import make_camera
from .scene import SceneBuilder

_ENV_MODES = {"sun": env_mod.PHYSICAL_SUN, "hdr": env_mod.HDR_MAP,
              "solid": env_mod.SOLID_COLOR}


def _compose_transform(spec: list[dict] | None) -> np.ndarray | None:
    if not spec:
        return None
    mats = []
    for step in spec:
        if len(step) != 1:
            raise ValueError(f"transform step must have one key: {step}")
        (op, arg), = step.items()
        if op == "translate":
            mats.append(geometry.translate(arg))
        elif op == "rotate_x":
            mats.append(geometry.rotate_x(float(arg)))
        elif op == "rotate_y":
            mats.append(geometry.rotate_y(float(arg)))
        elif op == "rotate_y_radians":
            mats.append(geometry.rotate_y_radians(float(arg)))
        elif op == "rotate_z":
            mats.append(geometry.rotate_z(float(arg)))
        elif op == "scale":
            arg = [arg] * 3 if np.ndim(arg) == 0 else arg
            mats.append(geometry.scale(arg))
        else:
            raise ValueError(f"unknown transform op: {op}")
    # Listed innermost first; compose() applies right to left.
    return geometry.compose(*reversed(mats))


def _load_textures(b: SceneBuilder, spec: dict, base_dir: str) -> dict[str, int]:
    from ..utils import image_io

    ids: dict[str, int] = {}
    for name, t in (spec or {}).items():
        kind = t.get("type", "image")
        if kind == "checker":
            ids[name] = b.textures.add_checker(
                float(t.get("scale", 1.0)),
                t.get("even", (0, 0, 0)), t.get("odd", (1, 1, 1)))
        elif kind == "image":
            path = os.path.join(base_dir, t["path"])
            img = image_io.load_image(path)
            if img is None and path.lower().endswith(".hdr"):
                img = image_io.load_hdr(path)
            ids[name] = (b.textures.add_missing() if img is None
                         else b.textures.add_image(img))
        else:
            raise ValueError(f"unknown texture type: {kind}")
    return ids


def _load_materials(b: SceneBuilder, spec: dict, tex: dict[str, int]) -> None:
    def tid(t):
        return tex[t] if t is not None else -1

    for name, m in (spec or {}).items():
        kind = m.get("type", "lambertian")
        texture = tid(m.get("texture"))
        bump = tid(m.get("bump"))
        strength = float(m.get("bump_strength", 1.0))
        if kind == "lambertian":
            b.materials.lambertian(name, m.get("albedo", (1, 1, 1)),
                                   texture, bump, strength)
        elif kind == "metal":
            b.materials.metal(name, m.get("albedo", (1, 1, 1)),
                              float(m.get("fuzz", 0.0)), texture, bump,
                              strength)
        elif kind == "dielectric":
            b.materials.dielectric(name, float(m.get("ior", 1.5)),
                                   m.get("albedo", (1, 1, 1)), bump, strength)
        elif kind == "diffuse_light":
            b.materials.diffuse_light(name, m.get("emit", m.get("albedo",
                                                                (1, 1, 1))))
        elif kind == "isotropic":
            b.materials.isotropic(name, m.get("albedo", (1, 1, 1)), texture)
        else:
            raise ValueError(f"unknown material type: {kind}")


def _load_objects(b: SceneBuilder, spec: list, base_dir: str) -> None:
    for o in spec or []:
        kind = o["type"]
        tf = _compose_transform(o.get("transform"))
        if kind == "fog_sphere":
            b.add_fog_sphere(o["center"], float(o["radius"]),
                             float(o["density"]), o.get("color", (1, 1, 1)))
            continue
        if kind == "fog_box":
            b.add_fog_box(o["min"], o["max"], float(o["density"]),
                          o.get("color", (1, 1, 1)))
            continue
        if kind not in ("sphere", "box", "cube", "mesh"):
            raise ValueError(f"unknown object type: {kind}")
        mat = b.materials.get(o["material"])
        if kind == "sphere":
            b.geometry.add_sphere(o["center"], float(o["radius"]), mat,
                                  transform=tf)
        elif kind == "box":
            b.geometry.add_box(o["min"], o["max"], mat, transform=tf)
        elif kind == "cube":
            b.geometry.add_cube(o.get("center", (0, 0, 0)), mat, transform=tf)
        else:
            mesh = obj_mod.load_obj(os.path.join(base_dir, o["path"]))
            if mesh is None or mesh.count == 0:
                continue   # empty-model fallback (model.hpp:18-21)
            # The reference passes the SceneBuilder here, which raises
            # (ROADMAP queue 3); the triangles go to its GeometryBuilder.
            obj_mod.add_mesh(b.geometry, mesh, mat, transform=tf,
                             target_scale=float(o.get("scale", 1.0)))


def _load_environment(spec: dict | None, base_dir: str):
    spec = dict(spec or {})
    mode = _ENV_MODES[spec.pop("mode", "sun")]
    hdr_path = spec.pop("hdr_path", None)
    if hdr_path is not None:
        from ..utils import image_io

        img = image_io.load_hdr(os.path.join(base_dir, hdr_path))
        spec["hdr_image"] = (env_mod.load_hdr_by_name(hdr_path) if img is None
                             else img)
    astro = spec.pop("astronomical", None)
    if astro is not None:
        lat = astro.get("latitude", 50.0)
        day = astro.get("day", 172)
        hour = astro.get("hour", 12.0)
        elev, _ = env_mod.solar_position(lat, day, hour)
        spec["sun_direction"] = np.asarray(
            env_mod.sun_direction_from_time(lat, day, hour))
        if astro.get("auto_sun_color", True):
            spec["sun_color"] = np.asarray(env_mod.auto_sun_color(elev))
    return env_mod.make_environment(**spec), mode


def load_scene_file(path: str, with_bvh: bool = True):
    """Load a JSON scene document: (scene, camera, environment, config),
    ready for integrator.render."""
    with open(path) as f:
        doc = json.load(f)
    return load_scene_dict(doc, base_dir=os.path.dirname(os.path.abspath(path)),
                           with_bvh=with_bvh)


def load_scene_dict(doc: dict, base_dir: str = ".", with_bvh: bool = True):
    """(scene, camera, environment, config) of a scene document; relative
    mesh, image and HDR paths resolve against base_dir."""
    b = SceneBuilder()
    tex = _load_textures(b, doc.get("textures"), base_dir)
    _load_materials(b, doc.get("materials"), tex)
    _load_objects(b, doc.get("objects"), base_dir)
    env, mode = _load_environment(doc.get("environment"), base_dir)
    scene = b.build(with_bvh=with_bvh)

    render_kwargs: dict[str, Any] = dict(doc.get("render", {}))
    render_kwargs.setdefault("env_mode", mode)
    config = RenderConfig(**render_kwargs)

    cam_kwargs = dict(doc.get("camera", {}))
    cam_kwargs.setdefault("image_width", config.width)
    cam_kwargs.setdefault("image_height", config.height)
    return scene, make_camera(**cam_kwargs), env, config


def save_scene_file(path: str, doc: dict) -> None:
    """Write a scene document (load_scene_file reads it back)."""
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
