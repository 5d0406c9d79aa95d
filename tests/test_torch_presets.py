"""The port's remaining presets, meshes and OBJ reader against the
reference package's, on the CPU: every table of the Shirley, Cornell and
funnel scenes bit for bit (coefficient tables and fog volumes included),
the procedural meshes' vertices, the compact closest-hit rows of each new
preset, and parse_obj / load_obj on OBJ files written to a temporary
directory."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import assets as jassets
from raytracer_project_tpu.models import obj as jobj
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu_torch import native
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import assets as tassets
from raytracer_project_tpu_torch.models import obj as tobj
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as k1

torch.set_num_threads(2)

PRESETS = {
    "shirley5": ("shirley_final_scene", dict(grid=5)),
    "shirley11": ("shirley_final_scene", dict(grid=11)),
    "cornell_fog": ("cornell_box_scene", dict(with_fog=True)),
    "funnel": ("bvh_stress_scene", dict(n_spheres=512, mesh_detail=1)),
}
MESHES = ("torus_mesh", "torus_knot_mesh", "pyramid_mesh", "bowl_mesh")


def _jax_flat(obj, prefix=""):
    """{dotted path: numpy} of a reference NamedTuple, the BVH left out
    (tests/test_torch_bvh.py holds it)."""
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


@pytest.fixture(scope="module")
def built():
    """name -> (the reference's scene, the port's), both without a BVH."""
    out = {}
    for name, (fn, kw) in PRESETS.items():
        out[name] = (getattr(jpresets, fn)(with_bvh=False, **kw),
                     getattr(tpresets, fn)(with_bvh=False, **kw))
    return out


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_tables_bit_equal(built, name):
    """Geometry, materials, textures, coefficient tables, chunk bounds and
    fog volumes."""
    jsc, tsc = built[name]
    _assert_bit_equal(_jax_flat(jsc), flatten(tsc))
    assert tsc.primitive_count == jsc.primitive_count
    assert (tsc.volumes is None) == (jsc.volumes is None)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_scan_tables_accept_reference_tables(built, name):
    """Every coefficient outside the slot lists is 0 in the reference's
    tables of the preset (so compaction accepts them), and the compact rows
    gathered from them equal the port's."""
    jsc, tsc = built[name]
    port = k1.scan_tables(tsc)
    jmm = jsc.mm
    for coeff, n, slots, width, rows in zip(
            (jmm.sphere_coeff, jmm.tri_coeff, jmm.box_coeff), port.counts,
            k1.SLOTS, k1.ROW_WIDTHS, port.rows):
        coeff = torch.as_tensor(np.array(coeff))
        listed = np.zeros(coeff.shape[:2], bool)
        for g, ks in enumerate(slots):
            listed[list(ks), g] = True
        assert not coeff[:, :, :n].numpy()[~listed].any()
        assert torch.equal(k1.compact_rows(coeff, n, slots, width), rows)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_vertices_bit_equal(name):
    jm, tm = getattr(jassets, name)(), getattr(tassets, name)()
    assert tm.count == jm.count > 0
    for f in ("v0", "v1", "v2", "n0", "n1", "n2"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_funnel_sizes():
    """bench.py's funnel: 8,192 spheres, two tori of 8,448 triangles."""
    sc = tpresets.bvh_stress_scene(n_spheres=8192, mesh_detail=2,
                                   with_bvh=False)
    assert (sc.spheres.count, sc.triangles.count) == (8194, 16896)


OBJ_NORMALS = """# every face corner names a normal
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vn 0 0 1
vn 0 0.6 0.8
f 1//1 2//1 3//1
f 1/1/2 3/2/2 4/1/2
f -5//-2 -4//-2 -1//-1
f 1/1/1 2/2/1 5/1/2 4/2/2
"""

OBJ_PLAIN = """v 0 0 0
v 2 0 0
v 2 2 0.5
v 0 2 0.5
f 1 2 3 4
f -4 -2 -1
f 1/1 2/2 4/1
"""


@pytest.mark.parametrize("text", [OBJ_NORMALS, OBJ_PLAIN],
                         ids=["normals", "plain"])
def test_parse_obj_matches_reference(tmp_path, text):
    """The v, v//vn and v/vt/vn forms, negative indices and quads (fan
    triangulation): the same corners and normals as the reference's
    parse_obj; load_obj gives the same mesh through the native parser and
    through the Python one."""
    ref = jobj.parse_obj(text)
    got = tobj.parse_obj(text)
    assert got.count == ref.count > 0
    for f in ("v0", "v1", "v2", "n0", "n1", "n2"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    path = tmp_path / "mesh.obj"
    path.write_text(text)
    assert native.available()
    parsed = native.parse_obj(str(path))
    loaded = tobj.load_obj(str(path))
    for f in ("v0", "v1", "v2", "n0", "n1", "n2"):
        want = getattr(got, f)
        for mesh in (parsed[f], getattr(loaded, f)):
            assert (mesh is None) == (want is None), f
            if want is not None:
                np.testing.assert_array_equal(mesh, want)


def test_load_obj_missing_file(tmp_path):
    assert tobj.load_obj(str(tmp_path / "missing.obj")) is None


def test_asset_root_obj_replaces_procedural_mesh(tmp_path, monkeypatch):
    """A models/<name>.obj under RAYTRACER_TPU_ASSETS replaces the
    procedural mesh, as in the reference."""
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "pyramid.obj").write_text(OBJ_PLAIN)
    monkeypatch.setenv("RAYTRACER_TPU_ASSETS", str(tmp_path))
    mesh = tassets._obj_or("pyramid", lambda: None)
    np.testing.assert_array_equal(mesh.v0, tobj.parse_obj(OBJ_PLAIN).v0)
    assert tassets._obj_or("bowl", lambda: "procedural") == "procedural"
