"""The port's scene builders against the reference's: every packed table of
the showcase scene bit for bit, and the numpy hand-over of scenes, cameras
and environments."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models import geometry as tgeo
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.models.scene import scene_from_numpy

torch.set_num_threads(2)


def _jax_flat(obj, prefix=""):
    """{dotted path: numpy} of a reference NamedTuple (BVH, media left out;
    tests/test_torch_bvh.py holds the BVH)."""
    out = {}
    if obj is None:
        return out
    if hasattr(obj, "_fields"):
        for name, val in zip(obj._fields, obj):
            if name in ("bvh", "volumes"):
                continue
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
def showcase():
    return (_jax_flat(jpresets.showcase_scene(with_bvh=False)),
            tpresets.showcase_scene(with_bvh=False))


def test_showcase_tables_bit_equal(showcase):
    """Geometry (Morton order, baked affines, the rotate_y quirk),
    materials, textures, closest-hit coefficients and chunk bounds."""
    ref, scene = showcase
    _assert_bit_equal(ref, flatten(scene))
    assert scene.primitive_count == 1454
    assert (scene.spheres.count, scene.triangles.count, scene.boxes.count) == (
        455, 552, 447)
    assert scene.materials.count == 34 and scene.textures.count == 8


def test_small_builder_tables_bit_equal():
    """A hand-built scene with every primitive type and transform."""
    def build(b, geo):
        tex = b.textures.add_checker(0.5, (0.9, 0.9, 0.9), (0.1, 0.2, 0.3))
        red = b.materials.lambertian("red", (0.7, 0.2, 0.1), texture_id=tex)
        glass = b.materials.dielectric("glass", 1.5)
        b.geometry.add_sphere((0, 1, 0), 1.0, red,
                              transform=geo.compose(geo.translate((1, 0, 0)),
                                                    geo.scale(2.0)))
        b.geometry.add_box((-1, -1, -1), (1, 2, 1), glass,
                           transform=geo.compose(geo.rotate_y(30.0),
                                                 geo.rotate_x(-20.0)))
        b.geometry.add_box_triangles((0, 0, 0), (1, 1, 1), red)
        return b.build(with_bvh=False)

    from raytracer_project_tpu.models import geometry as jgeo

    _assert_bit_equal(_jax_flat(build(JBuilder(), jgeo)),
                      flatten(build(TBuilder(), tgeo)))


def test_scene_from_numpy_round_trip(showcase):
    ref, scene = showcase
    again = scene_from_numpy(ref)
    _assert_bit_equal(ref, flatten(again))
    assert again.boxes.count == scene.boxes.count


def test_camera_and_environment_from_numpy():
    kw = dict(image_width=96, image_height=54, vfov=30.0,
              lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.6, focus_dist=10.0)
    jc = jcam.make_camera(**kw)
    ref = {k: np.asarray(v) for k, v in jc._asdict().items()}
    _assert_bit_equal(ref, flatten(tcam.make_camera(**kw)))
    _assert_bit_equal(ref, flatten(tcam.camera_from_numpy(ref)))

    hdr = np.linspace(0, 1, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    ekw = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0,
               hdr_image=hdr, hdri_rotation=0.3)
    je = jenv.make_environment(**ekw)
    eref = {k: np.asarray(v) for k, v in je._asdict().items()}
    _assert_bit_equal(eref, flatten(tenv.make_environment(**ekw)))
    _assert_bit_equal(eref, flatten(tenv.environment_from_numpy(eref)))


def test_astronomical_sun_matches():
    for lat, day, hour in ((45.0, 172, 15.5), (-33.0, 10, 7.0)):
        je, ja = jenv.solar_position(lat, day, hour)
        te, ta = tenv.solar_position(lat, day, hour)
        np.testing.assert_allclose([float(te), float(ta)],
                                   [float(je), float(ja)], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            tenv.sun_direction_from_time(lat, day, hour).numpy(),
            np.asarray(jenv.sun_direction_from_time(lat, day, hour)),
            atol=1e-5)
        np.testing.assert_allclose(tenv.auto_sun_color(te).numpy(),
                                   np.asarray(jenv.auto_sun_color(je)),
                                   atol=1e-5)
