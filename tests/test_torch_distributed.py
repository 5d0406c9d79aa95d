"""Two processes render one frame over a gloo process group on the CPU
(parallel/distributed.py) and equal the one-process render."""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models.scene import SceneBuilder
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.parallel import distributed

torch.set_num_threads(2)


def _setup():
    b = SceneBuilder()
    ground = b.materials.lambertian("g", (0.5, 0.5, 0.5))
    glass = b.materials.dielectric("d", 1.5)
    light = b.materials.diffuse_light("l", (4.0, 4.0, 4.0))
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.geometry.add_box((0.8, 0.0, -0.4), (1.6, 1.2, 0.4), light)
    cfg = tint.RenderConfig(width=25, height=15, samples_per_pixel=2,
                            max_depth=5, env_mode=tenv.SOLID_COLOR)
    cam = tcam.make_camera(image_width=25, image_height=15, vfov=40.0,
                           lookfrom=(0.0, 1.5, 4.0), lookat=(0.0, 0.5, 0.0))
    env = tenv.make_environment(background_color=(0.7, 0.8, 1.0))
    return b.build(), cam, env, cfg


def _worker(rank, world, init_file, out_path):
    torch.set_num_threads(1)
    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=f"file://{init_file}",
                                        device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    try:
        scene, cam, env, cfg = _setup()
        img = distributed.render_distributed(scene, cam, env, 7, cfg,
                                             device="cpu")
        beauty = torch.as_tensor(img["beauty"])
        # Each process's rows; the statistics over the group are the frame's.
        rows = beauty.reshape(-1, 3).chunk(world)[rank]
        stats = tpost.analyze_framebuffer_psum(rows)
        if distributed.is_host0():
            np.savez(out_path, beauty=img["beauty"],
                     avg=stats.average_luminance.numpy(),
                     hist=stats.histogram.numpy())
    finally:
        torch.distributed.destroy_process_group()


def test_two_process_render_matches_one_process(tmp_path):
    """2 spawned ranks (file:// init, gloo) render their windows of 25x15
    (375 pixels: 188 + 187 and one padding slot) and gather to rank 0; the
    frame equals the one-process render within the reference's shard
    tolerance (rtol 3e-6, atol 3e-7), and the group's statistics equal
    the frame's."""
    out = str(tmp_path / "out.npz")
    ctx = mp.start_processes(_worker, args=(2, str(tmp_path / "init"), out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(240):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail("the ranks did not finish within 240 s")
    got = np.load(out)
    scene, cam, env, cfg = _setup()
    single = tint.render(scene, cam, env, 7, cfg, device="cpu")["beauty"]
    np.testing.assert_allclose(got["beauty"], single.numpy(), rtol=3e-6,
                               atol=3e-7)
    whole = tpost.analyze_framebuffer(single)
    np.testing.assert_allclose(got["avg"], whole.average_luminance.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["hist"], whole.histogram.numpy())


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    """One process (the variables unset, or NUM_PROCESSES=1) makes no
    group, and the helpers act on the one process."""
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("NUM_PROCESSES", "1")
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_host0()
    mesh, owners = distributed.make_global_mesh(
        distributed.local_devices("cpu"))
    assert mesh == [torch.device("cpu")] and owners == [0]
    ids = np.arange(10)
    np.testing.assert_array_equal(distributed.local_shard(ids, owners), ids)
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(distributed.gather_to_host0(x), x.numpy())
