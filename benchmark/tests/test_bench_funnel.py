"""The `funnel` configuration: its generator against the port's preset, its
cell at a size the CPU holds (through the fused pool's BVH route), the
reader of `hit.roofline_share`, and the control against the cell's limit."""

import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness, roofline
from benchmark.reference import render
from benchmark.tests import tiny

CELL = "funnel.turntable"


def test_the_generator_is_the_ports_funnel():
    """Both builders receive presets.bvh_stress_scene(8192, mesh_detail=2)
    primitive for primitive, with the port bench's funnel camera and sun."""
    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.models.scene import SceneBuilder

    cell = tiny.load_cell(CELL)
    b = SceneBuilder()
    cell.generator.build(b, cell.cfg)
    port = b.build(with_bvh=False)
    want = presets.bvh_stress_scene(8192, mesh_detail=2, with_bvh=False)
    assert (port.spheres.count, port.triangles.count) == (8194, 16896)
    for table in ("spheres", "triangles", "boxes", "materials", "textures"):
        for x, y in zip(getattr(port, table), getattr(want, table)):
            assert torch.equal(x, y), table
    ref = render.build_scene(cell.generator, cell.cfg)
    for table in ("spheres", "triangles", "materials"):
        for x, y in zip(getattr(ref, table), getattr(want, table)):
            assert torch.equal(torch.as_tensor(x), y), table
    cam = cell.cfg["camera"]
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in cam.items()} == bench.FUNNEL_CAM
    env = cell.cfg["environment"]
    assert env["mode"] == "PHYSICAL_SUN"
    assert tuple(env["sun_direction"]) == bench.SUN["sun_direction"]
    assert env["sun_intensity"] == bench.SUN["sun_intensity"]
    assert cell.cfg["render"]["max_depth"] == 10
    assert cell.cfg["reduced"] == [] and cell.chips == 1


def test_the_cell_passes_its_check_through_the_bvh_route(monkeypatch):
    """16x9 frames of 2 spp on the CPU: the port's pool walks the BVH (the
    plain traversal) and never K1's scan, and the check against the
    reference's full scan passes."""
    from raytracer_project_tpu_torch.ops import bvh, closest_hit

    cell = tiny.load_cell(CELL, traffic=tiny.traffic(
        spp=2, update_spp=2, width=16, height=9))
    calls = {"closest_hit_plain": 0, "bvh_closest_hit_plain": 0}
    for name in calls:
        def spy(*args, _fn=getattr(closest_hit, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(closest_hit, name, spy)
    builds = bvh.hit_bvh.builds
    result, verdict = harness.run_cell(cell, 2**31 + 17, 6.0, False,
                                       time.perf_counter(), device="cpu")
    assert result["correct"], verdict
    assert verdict["checks"]["frames_checked"]["value"] == 2
    assert calls["bvh_closest_hit_plain"] > 0
    assert calls["closest_hit_plain"] == 0
    assert bvh.hit_bvh.builds == builds + 1
    assert set(result["metrics"]) == {"samples_per_s", "setup_s"}


def test_the_reader_takes_either_closest_hit_kernel():
    """hit.roofline_share reads K1's tile scan and the BVH kernel against
    the same bytes, and nothing without a trace or a closest-hit kernel."""
    read = harness.load_reader("hit.roofline_share").read
    counters = {"segments": 3_000, "steps": 10, "k1_launches": 11}
    nbytes = roofline.k1_bytes(3_000, 11, (2, 3, 4))
    want = 100 * nbytes / roofline.PEAK_BYTES_PER_S / 0.05
    for name in ("void tile_scan_kernel<true>(float)",
                 "bvh_hit_kernel(float const*, int, float)"):
        ctx = {"counters": counters, "counts": (2, 3, 4),
               "traces": [{"kernel_s": {name: 0.05, "Memcpy DtoH": 0.01}}]}
        assert read(ctx) == pytest.approx(want), name
    assert read({"counters": counters, "counts": (2, 3, 4), "traces": [
        {"kernel_s": {"void shade_kernel<false>()": 0.05}}]}) is None
    assert read({"counters": {}, "counts": (2, 3, 4), "traces": []}) is None


def test_the_control_fails_the_cells_limit():
    """The reference with its state in bfloat16, in the program's place,
    at a size the CPU holds, reads above the cell's limit."""
    cell = tiny.load_cell(CELL)
    ref = render.Reference(cell.generator, cell.cfg, "cpu")
    ids = np.arange(0, 40 * 24, 6)
    spp = 2
    want = ref.sums(cell.cfg["camera"], 40, 24, 9, ids, spp).numpy() / spp
    got = ref.sums(cell.cfg["camera"], 40, 24, 9, ids, spp,
                   round_to=torch.bfloat16).numpy() / spp
    nums = compare.numbers(got, want)
    assert nums["px_off_share"] > cell.limits["px_off_share"]["limit"]
    assert not compare.verdict(nums, cell.limits, 1)["correct"]
