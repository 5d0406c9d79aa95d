"""Both configurations' scenes against their sources."""

import numpy as np
import pytest
import torch

from benchmark.reference import render
from benchmark.tests import tiny


def _scene(name):
    cell = tiny.load_cell({"showcase": "showcase.turntable",
                              "cornell_smoke": "cornell_smoke.final"}[name])
    return cell, render.build_scene(cell.generator, cell.cfg)


def test_showcase_is_the_upstream_world_of_the_port_bench():
    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.models import presets

    cell, scene = _scene("showcase")
    assert (scene.spheres.count, scene.triangles.count, scene.boxes.count) == (
        455, 552, 447)
    ref = presets.showcase_scene(with_bvh=False)
    for table in ("spheres", "triangles", "boxes", "materials", "textures"):
        for a, b in zip(getattr(scene, table), getattr(ref, table)):
            assert torch.equal(a, b), table
    cam = cell.cfg["camera"]
    for k, v in bench.SHOWCASE_CAM.items():
        assert tuple(cam[k]) == v if isinstance(v, tuple) else cam[k] == v
    env = cell.cfg["environment"]
    assert env["mode"] == "PHYSICAL_SUN"
    assert tuple(env["sun_direction"]) == bench.SUN["sun_direction"]
    assert env["sun_intensity"] == bench.SUN["sun_intensity"]
    assert cell.cfg["render"]["max_depth"] == 10
    assert cell.cfg["reduced"] == []


def test_cornell_smoke_is_the_books_scene():
    """RTNW cornell_smoke: 555 box, light 7 under the ceiling over
    (113..443, 127..432), media of density 0.01 at the boxes' translated
    places (black tall, white short), vfov 40 from (278, 278, -800),
    black background, max_depth 50."""
    cell, scene = _scene("cornell_smoke")
    assert scene.boxes.count == 6 and float(scene.spheres.radius.max()) == 0.0
    mats = scene.materials
    emit = mats.albedo[mats.mtype == 3]
    assert torch.equal(emit, torch.tensor([[7.0, 7.0, 7.0]]))
    vol = scene.volumes
    assert vol.count == 2
    np.testing.assert_array_equal(vol.box_min.numpy(), [[265, 0, 295], [130, 0, 65]])
    np.testing.assert_array_equal((vol.box_max - vol.box_min).numpy(),
                                  [[165, 330, 165], [165, 165, 165]])
    np.testing.assert_allclose(vol.neg_inv_density.numpy(), [-100.0, -100.0])
    np.testing.assert_array_equal(mats.albedo[vol.mat.long()].numpy(),
                                  [[0, 0, 0], [1, 1, 1]])
    light = cell.cfg["scene"]
    assert light["light_min"][1] == 554.0
    assert np.subtract(light["light_max"], light["light_min"]).tolist() == [330.0, 1.0, 305.0]
    cam = cell.cfg["camera"]
    assert (cam["vfov"], tuple(cam["lookfrom"]), tuple(cam["lookat"])) == (
        40.0, (278.0, 278.0, -800.0), (278.0, 278.0, 0.0))
    assert cell.cfg["environment"] == {"mode": "SOLID_COLOR",
                                       "background_color": [0.0, 0.0, 0.0],
                                       "intensity": 1.0}
    assert cell.cfg["render"]["max_depth"] == 50
    assert cell.traffic["frame_spp"] == 200 and cell.traffic["width"] == 600
