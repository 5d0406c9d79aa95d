"""JSON scene files (models/sceneio.py) against the reference package's
loader on the CPU: examples/scene_demo.json gives the same tables, camera,
environment and RenderConfig; save/load round-trips, meshes and fog load;
image paths that do not load (the sentinel texture, a black sky)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import sceneio as jio
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import sceneio as tio

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "examples", "scene_demo.json")


def _jax_flat(obj, prefix=""):
    out = {}
    if obj is None:
        return out
    if hasattr(obj, "_fields"):
        for name, val in zip(obj._fields, obj):
            if name != "bvh":
                out.update(_jax_flat(val, f"{prefix}.{name}" if prefix else name))
        return out
    out[prefix] = np.asarray(obj)
    return out


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].reshape(-1).view(np.uint8),
                                      b[k].reshape(-1).view(np.uint8), err_msg=k)


def _assert_same(ref, got):
    (jsc, jcam, jenv, jcfg), (tsc, tcam, tenv, tcfg) = ref, got
    _assert_bit_equal(_jax_flat(jsc), flatten(tsc))
    _assert_bit_equal(_jax_flat(jcam), flatten(tcam))
    ref_env, got_env = _jax_flat(jenv), flatten(tenv)
    for k in ("sun_direction", "sun_color"):   # astronomical sun: f32 math
        np.testing.assert_allclose(got_env.pop(k), ref_env.pop(k), atol=1e-5)
    _assert_bit_equal(ref_env, got_env)
    tkw = dataclasses.asdict(tcfg)
    for k, v in tkw.items():
        assert getattr(jcfg, k) == v, k


def test_demo_scene_matches_reference():
    ref = jio.load_scene_file(DEMO, with_bvh=False)
    got = tio.load_scene_file(DEMO, with_bvh=False)
    _assert_same(ref, got)
    assert got[3].width == 400 and got[3].samples_per_pixel == 30


def test_round_trip_with_mesh_and_fog(tmp_path, monkeypatch):
    """A document with a mesh (an OBJ beside it), a fog box and a fog
    sphere, saved and loaded again, equals the reference's load of it; the
    BVH is built by default. The reference's loader hands its SceneBuilder
    to obj.add_mesh, which needs the GeometryBuilder and raises; the oracle
    is that loader with the call given the GeometryBuilder."""
    real_add_mesh = jio.obj_mod.add_mesh
    monkeypatch.setattr(jio.obj_mod, "add_mesh",
                        lambda b, *a, **kw: real_add_mesh(b.geometry, *a, **kw))
    (tmp_path / "tri.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    with open(DEMO) as f:
        doc = json.load(f)
    doc["objects"] += [
        {"type": "mesh", "path": "tri.obj", "scale": 2.0, "material": "red",
         "transform": [{"rotate_x": -90}, {"translate": [0, 0.1, 1]}]},
        {"type": "mesh", "path": "missing.obj", "material": "red"},
        {"type": "fog_box", "min": [-3, 0, -3], "max": [3, 2, 3],
         "density": 0.05, "color": [0.9, 0.9, 1.0]},
        {"type": "fog_sphere", "center": [0, 1, 0], "radius": 4.0,
         "density": 0.01},
    ]
    doc["environment"] = {"mode": "solid", "background_color": [0.2, 0.3, 0.4]}
    path = str(tmp_path / "scene.json")
    tio.save_scene_file(path, doc)
    got = tio.load_scene_file(path, with_bvh=False)
    _assert_same(jio.load_scene_file(path, with_bvh=False), got)
    assert got[0].volumes.count == 2 and got[0].triangles.count == 2
    assert tio.load_scene_file(path)[0].bvh is not None


@pytest.mark.parametrize("section", ["texture", "hdr_path"])
def test_image_paths_raise(section, tmp_path, monkeypatch):
    """Image paths load now and raise nothing: an image texture that does
    not load is the cyan missing-texture sentinel, an HDR map that does not
    load (and has no namesake under the asset root) is black; both as the
    reference's loader gives them. tests/test_torch_image_io.py loads real
    files."""
    monkeypatch.setenv("RAYTRACER_TPU_ASSETS", str(tmp_path))
    doc = {"objects": []}
    if section == "texture":
        doc["textures"] = {"wood": {"type": "image", "path": "wood.png"}}
        doc["materials"] = {"m": {"type": "lambertian", "texture": "wood"}}
    else:
        doc["environment"] = {"mode": "hdr", "hdr_path": "sky.hdr"}
    got = tio.load_scene_dict(doc, base_dir=str(tmp_path), with_bvh=False)
    _assert_same(jio.load_scene_dict(doc, base_dir=str(tmp_path),
                                     with_bvh=False), got)
    if section == "texture":
        assert int(got[0].textures.kind[-1]) == 2   # KIND_MISSING
    else:
        assert float(got[2].hdr_image.abs().max()) == 0.0
