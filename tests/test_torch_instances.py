"""Two-level instancing (models/instances.py) against the reference
package's on the CPU: the tables after `build` and after `rebuild` bit for
bit, the O(moved triangles) host work, the two-level closest hit, and the
compact closest-hit rows of the moved scene, built once per render."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import geometry as jgeo
from raytracer_project_tpu.models import instances as jinst
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import geometry as tgeo
from raytracer_project_tpu_torch.models import instances as tinst
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import intersect as tis

torch.set_num_threads(2)

MOVE = (2.0, 1.7, -0.5)


def _grid_mesh(n=6):
    """2*n*n-triangle height-field patch (tests/test_instances.py)."""
    xs = np.linspace(0, 1, n + 1)
    v0, v1, v2 = [], [], []
    for i in range(n):
        for j in range(n):
            a = [xs[i], 0.1 * np.sin(i + j), xs[j]]
            b = [xs[i + 1], 0.1 * np.sin(i + 1 + j), xs[j]]
            c = [xs[i], 0.1 * np.sin(i + j + 1), xs[j + 1]]
            dd = [xs[i + 1], 0.1 * np.sin(i + j + 2), xs[j + 1]]
            v0 += [a, b]
            v1 += [b, dd]
            v2 += [c, c]
    return tuple(np.asarray(x, np.float64) for x in (v0, v1, v2))


def _world(inst_mod, builder_cls, geo, n_instances=3):
    w = inst_mod.InstancedWorld()
    mid = w.add_mesh(*_grid_mesh(6), name="patch")
    b = builder_cls()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.2))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, red)
    for i in range(n_instances):
        w.add_instance(mid, geo.translate((2.0 * i, 0.5, 0.0)), red)
    return w, b


def _jax_flat(scene) -> dict:
    out = {}
    for name, val in zip(scene._fields, scene):
        if val is None or name == "bvh":
            continue
        for f, x in zip(val._fields, val):
            if x is not None:
                out[f"{name}.{f}"] = np.array(x)
    return out


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].reshape(-1).view(np.uint8),
                                      b[k].reshape(-1).view(np.uint8), err_msg=k)


@pytest.fixture(scope="module")
def worlds():
    """Both packages' worlds, the tables after build and after moving
    instance 1 (copied at once: the reference's rebuild writes into the
    arrays its first scene holds)."""
    out = {}
    for key, mod, builder, geo in (("ref", jinst, JBuilder, jgeo),
                                   ("port", tinst, TBuilder, tgeo)):
        w, b = _world(mod, builder, geo)
        first = w.build(b)
        first_flat = _jax_flat(first) if key == "ref" else flatten(first)
        w.triangles_recomputed = 0
        w.set_transform(1, geo.translate(MOVE))
        moved = w.rebuild()
        out[key] = dict(world=w, first=first_flat, moved=moved,
                        moved_flat=(_jax_flat(moved) if key == "ref"
                                    else flatten(moved)))
    return out


@pytest.mark.parametrize("stage", ["first", "moved_flat"])
def test_tables_bit_equal(worlds, stage):
    _assert_bit_equal(worlds["ref"][stage], worlds["port"][stage])


def test_rebuild_work_and_untouched_blocks(worlds):
    """The rebuild recomputed only the moved instance's triangles, and the
    other instances' rows kept their bits."""
    w = worlds["port"]["world"]
    k = w.meshes[0].count
    assert w.triangles_recomputed == k
    first, moved = worlds["port"]["first"], worlds["port"]["moved_flat"]
    for i in (0, 2):
        s = w.instances[i].start
        np.testing.assert_array_equal(first["triangles.v0"][s:s + k],
                                      moved["triangles.v0"][s:s + k])
    s = w.instances[1].start
    assert not np.array_equal(first["triangles.v0"][s:s + k],
                              moved["triangles.v0"][s:s + k])


def _rays(n=512, seed=0):
    r = np.random.default_rng(seed)
    o = (r.normal(size=(n, 3)) * 2 + [2.0, 3.0, 6.0]).astype(np.float32)
    return o, r.normal(size=(n, 3)).astype(np.float32)


def test_intersect_instanced_matches_reference(worlds):
    """512 rays through the moved world: the same hits as the reference's
    two-level query (t within 2e-4; rows and types where t is not a tie)."""
    o, d = _rays(seed=7)
    ref = jinst.intersect_instanced(worlds["ref"]["world"],
                                    worlds["ref"]["moved"], o, d, 1e-3)
    got = tinst.intersect_instanced(worlds["port"]["world"],
                                    worlds["port"]["moved"], o, d, 1e-3)
    hit = np.asarray(ref.hit)
    assert 50 < hit.sum() < 512
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    tg, tr = got.t.numpy()[hit], np.asarray(ref.t)[hit]
    np.testing.assert_allclose(tg, tr, rtol=2e-4, atol=2e-4)
    clear = ~np.isclose(tg, tr, rtol=1e-5)
    for a, b in ((got.prim_idx, ref.prim_idx), (got.prim_type, ref.prim_type)):
        bad = (a.numpy()[hit] != np.asarray(b)[hit]) & clear
        assert not bad.any()
    # And the port's two-level query agrees with its flat closest hit.
    flat = tis.intersect(worlds["port"]["moved"], torch.as_tensor(o),
                         torch.as_tensor(d), 1e-3,
                         tis.hit_tables(worlds["port"]["moved"]))
    assert torch.equal(flat.hit, got.hit)


def test_scan_rows_rebuilt_once_per_render(worlds, monkeypatch):
    """After rebuild, a render builds the compact closest-hit rows once,
    from the moved coefficient tables: they equal those of a fresh
    scan_tables of a from-scratch world with the instance already moved."""
    scene = worlds["port"]["moved"]
    built = []
    real = k1.scan_tables
    monkeypatch.setattr(k1, "scan_tables",
                        lambda s: built.append(real(s)) or built[-1])
    cam = tcam.make_camera(image_width=8, image_height=6, vfov=40.0,
                           lookfrom=(2.0, 3.0, 6.0), lookat=(2.0, 0.5, 0.0))
    env = tenv.make_environment()
    for wavefront in (True, False):
        built.clear()
        cfg = tint.RenderConfig(width=8, height=6, samples_per_pixel=1,
                                max_depth=2, wavefront=wavefront)
        tint.render(scene, cam, env, 0, cfg, device="cpu")
        assert len(built) == 1, wavefront
    w, b = _world(tinst, TBuilder, tgeo)
    w.instances[1].transform = tgeo.translate(MOVE)
    fresh = real(w.build(b))
    for a, c in zip(built[0].rows, fresh.rows):
        assert torch.equal(a, c)


def test_add_obj_registers_a_normalized_mesh(tmp_path):
    """add_obj loads the file once (normalized: centred, bottom at y = 0,
    scaled) as a mesh asset with its own BVH; a missing file raises."""
    (tmp_path / "quad.obj").write_text(
        "v 0 1 0\nv 2 1 0\nv 2 3 1\nv 0 3 1\nf 1 2 3 4\n")
    w = tinst.InstancedWorld()
    mid = w.add_obj(str(tmp_path / "quad.obj"), target_scale=0.5)
    mesh = w.meshes[mid]
    assert mesh.count == 2 and mesh.local_bvh is mesh.local_scene.bvh
    pts = np.concatenate([mesh.v0, mesh.v1, mesh.v2])
    np.testing.assert_allclose(pts.min(0), [-0.5, 0.0, -0.25], atol=1e-6)
    np.testing.assert_allclose(pts.max(0), [0.5, 1.0, 0.25], atol=1e-6)
    with pytest.raises(FileNotFoundError):
        w.add_obj(str(tmp_path / "missing.obj"))
