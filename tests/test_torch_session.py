"""The port's progressive session (utils/session.py) on the CPU against the
reference's (raytracer_project_tpu/utils/session.py): the progressive
beauty, the AOVs (which the reference's progressive session undercounts),
checkpoints in both directions, cancel, progress, display and export, and
the mesh and two-rank layouts. Inputs: the reference test's `_session`
(tests/test_session.py), built in both packages from the same numbers."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.utils import session as jsession
from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.parallel import distributed
from raytracer_project_tpu_torch.parallel import render as prender
from raytracer_project_tpu_torch.utils import image_io
from raytracer_project_tpu_torch.utils import session as tsession

torch.set_num_threads(2)

AOVS = ("albedo", "normal", "z_depth")


def _parts(builder, cam_mod, env_mod, int_mod):
    b = builder()
    m = b.materials.lambertian("m", (0.6, 0.3, 0.2))
    light = b.materials.diffuse_light("l", (5.0, 5.0, 5.0))
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, m)
    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, light)
    cfg = int_mod.RenderConfig(width=12, height=8, samples_per_pixel=8,
                               max_depth=4, env_mode=env_mod.SOLID_COLOR)
    cam = cam_mod.make_camera(image_width=cfg.width, image_height=cfg.height,
                              lookfrom=(0, 2, 6), lookat=(0, 1, 0), vfov=35.0)
    env = env_mod.make_environment(background_color=(0.6, 0.7, 0.9))
    return b.build(), cam, env, cfg


def _ref(chunk=2):
    scene, cam, env, cfg = _parts(JBuilder, jcam, jenv, jint)
    return jsession.RenderSession(scene, cam, env, cfg,
                                  key=jax.random.PRNGKey(9),
                                  chunk_samples=chunk)


def _port(chunk=2, **kw):
    scene, cam, env, cfg = _parts(TBuilder, tcam, tenv, tint)
    return tsession.RenderSession(scene, cam, env, cfg, key=9,
                                  chunk_samples=chunk, device="cpu", **kw)


def _tie_robust(name, a, b):
    """tests/test_torch_pool.py's rule: mean |d| < 1e-3 and at most 0.5% of
    values over 3e-3."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert d.mean() < 1e-3, (name, d.mean())
    assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())


def _host(buffers):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in buffers.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's progressive session (chunks of 2 to 8 spp), its
    one-shot session (one chunk of 8) and a session of its first chunk."""
    prog = _ref()
    prog.render_progressive(8)
    one = _ref(chunk=8)
    one.step(8)
    first = _ref()
    first.step(2)
    return {"prog": prog, "one": one, "prog_buf": _host(prog.buffers()),
            "one_buf": _host(one.buffers()), "first": _host(first.buffers())}


@pytest.fixture(scope="module")
def port_prog():
    s = _port()
    s.render_progressive(8)
    return s


def test_progressive_matches_reference(reference, port_prog):
    """Chunks of 2 to 8 spp at PRNGKey(9): beauty under the tie-robust rule,
    segments within 0.5%."""
    assert port_prog.samples_done == 8
    _tie_robust("beauty", port_prog.buffers()["beauty"],
                reference["prog_buf"]["beauty"])
    ref_seg = reference["prog"].segments_traced
    assert abs(port_prog.segments_traced - ref_seg) <= 0.005 * ref_seg


def test_progressive_aovs_equal_the_one_shot(reference, port_prog):
    """The port's progressive AOVs hold the reference's one-shot AOVs; the
    reference's progressive AOVs count its first chunk only (2 of 8
    samples), so they are a quarter of its one-shot ones."""
    got = port_prog.buffers()
    for name in AOVS:
        assert float(got[name].abs().max()) > 0, name
        _tie_robust(name, got[name], reference["one_buf"][name])
        prog, one = reference["prog_buf"][name], reference["one_buf"][name]
        np.testing.assert_allclose(prog * 4.0, reference["first"][name],
                                   rtol=1e-6, atol=1e-7)
        assert 0.2 < prog.mean() / one.mean() < 0.3, name
    one = _port(chunk=8)
    one.step(8)
    for name in AOVS:
        np.testing.assert_allclose(got[name].numpy(),
                                   one.buffers()[name].numpy(),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("wavefront", [True, False])
def test_progressive_aovs_past_519_spp(wavefront):
    """At 576 spp the render's AOV budget is 72 samples, while a chunk of 64
    derives a budget of 64 from its own spp: the session hands every chunk
    the render's budget, so its AOVs still equal the one-shot render's
    (fused pool and chunked engine, 4x2 pixels)."""
    scene, cam, env, cfg = _parts(TBuilder, tcam, tenv, tint)
    cfg = dataclasses.replace(cfg, width=4, height=2, samples_per_pixel=576,
                              max_depth=2, wavefront=wavefront)
    cam = tcam.make_camera(image_width=4, image_height=2, lookfrom=(0, 2, 6),
                           lookat=(0, 1, 0), vfov=35.0)
    assert cfg.aux_samples == 72
    assert dataclasses.replace(cfg, samples_per_pixel=64).aux_samples == 64

    def run(chunk):
        s = tsession.RenderSession(scene, cam, env, cfg, key=9,
                                   chunk_samples=chunk, device="cpu")
        s.render_progressive(576)
        return s.buffers()

    prog, one = run(64), run(576)
    for name in AOVS:
        np.testing.assert_allclose(prog[name].numpy(), one[name].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference checkpoint at 4 spp, finished to 8 in the port, holds the
    reference's own finish (beauty under the tie-robust rule)."""
    ref = _ref()
    ref.render_progressive(4)
    path = str(tmp_path / "ref.npz")
    ref.checkpoint(path)
    port = _port()
    port.restore(path)
    assert port.samples_done == 4 and port.key == rng.Key(0, 9)
    np.testing.assert_array_equal(port.acc.beauty.numpy(),
                                  np.asarray(ref.acc.beauty))
    ref.render_progressive(8)
    port.render_progressive(8)
    _tie_robust("beauty", port.buffers()["beauty"], ref.buffers()["beauty"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The reverse: a port checkpoint at 4 spp finished to 8 in the
    reference holds the port's finish; the file has the reference's keys
    and dtypes."""
    port = _port()
    port.render_progressive(4)
    path = str(tmp_path / "port.npz")
    port.checkpoint(path)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["beauty", "albedo", "normal", "z_depth", "reflection",
             "refraction", "key", "samples_done", "config"])
        assert data["key"].dtype == np.uint32 and data["beauty"].dtype == np.float32
        np.testing.assert_array_equal(data["key"],
                                      np.asarray(jax.random.PRNGKey(9)))
    ref = _ref()
    ref.restore(path)
    assert ref.samples_done == 4
    ref.render_progressive(8)
    port.render_progressive(8)
    _tie_robust("beauty", port.buffers()["beauty"], ref.buffers()["beauty"])


def test_checkpoint_config_mismatch(tmp_path):
    s = _port()
    s.step(2)
    path = str(tmp_path / "ck.npz")
    s.checkpoint(path)
    s2 = _port()
    s2.config = dataclasses.replace(s2.config, max_depth=6)
    with pytest.raises(ValueError, match="config mismatch"):
        s2.restore(path)


def test_cancel_progress_and_eta():
    s = _port()
    assert s.progress(8) == 0.0 and s.eta_seconds(8) == float("inf")
    s.render_progressive(8, callback=lambda sess: sess.cancel())
    assert s.samples_done == 2 and s.progress(8) == 0.25
    assert float(s.buffers()["beauty"].mean()) > 0.0
    assert s.eta_seconds(8) < float("inf")
    assert any("cancelled at 2 samples" in e for e in s.log.entries)


def test_display_matches_reference(tmp_path):
    """display(PASS_RGB) and display(PASS_DENOISE) (the U-Net with the
    shipped weights in both packages) of a one-shot session within 1 LSB
    of the reference's; save_all_passes writes six PNGs that read back."""
    ref = _ref(chunk=8)
    ref.step(8)
    port = _port(chunk=8)
    port.step(8)
    for pid in (tpost.PASS_RGB, tpost.PASS_DENOISE, tpost.PASS_ALBEDO):
        got = port.display(pid)
        want = ref.display(pid)
        assert got.shape == (8, 12, 3) and got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, (pid, d.max())
    paths = port.save_all_passes(str(tmp_path / "out"))
    assert len(paths) == 6
    for path, pid in zip(paths, (tpost.PASS_RGB, tpost.PASS_ALBEDO,
                                 tpost.PASS_NORMALS, tpost.PASS_REFLECTIONS,
                                 tpost.PASS_REFRACTIONS, tpost.PASS_Z_DEPTH)):
        np.testing.assert_array_equal(image_io.read_png(path),
                                      port.display(pid))


def test_mesh_session_equals_the_single_device_one(port_prog):
    """mesh = the CPU listed 3 times (96 pixels, no padding) and 5 times (4
    padding rows): sums within the reference's shard tolerance, and the
    statistics equal the frame's (the padding rows left out)."""
    for n in (3, 5):
        s = _port(mesh=prender.make_mesh(n, device="cpu"))
        s.render_progressive(8)
        for name, a in s.buffers().items():
            np.testing.assert_allclose(a.numpy(),
                                       port_prog.buffers()[name].numpy(),
                                       rtol=3e-6, atol=3e-7, err_msg=name)
        np.testing.assert_allclose(
            s.statistics().average_luminance.numpy(),
            port_prog.statistics().average_luminance.numpy(), rtol=1e-5)


def _rank_worker(rank, world, init_file, out_path, ck_path):
    torch.set_num_threads(1)
    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=f"file://{init_file}",
                                        device="cpu")
    try:
        mesh, owners = distributed.make_global_mesh(
            distributed.local_devices("cpu"))
        s = _port(mesh=mesh, owners=owners)
        s.render_progressive(4)
        s.checkpoint(ck_path)
        s.render_progressive(8)
        buf = s.buffers()
        stats = s.statistics()
        if distributed.is_host0():
            np.savez(out_path, rows=s.acc.beauty.shape[0],
                     avg=stats.average_luminance.numpy(),
                     **{k: v.numpy() for k, v in buf.items()})
    finally:
        torch.distributed.destroy_process_group()


def test_two_rank_session_matches_one_process(tmp_path, port_prog):
    """Two spawned gloo ranks, each rendering its window (48 of 96 pixels)
    of the session: the gathered buffers equal the one-process session,
    and the checkpoint written at 4 spp restores in one process."""
    out, ck = str(tmp_path / "out.npz"), str(tmp_path / "ck.npz")
    ctx = mp.start_processes(_rank_worker,
                             args=(2, str(tmp_path / "init"), out, ck),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(240):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail("the ranks did not finish within 240 s")
    got = np.load(out)
    assert int(got["rows"]) == 48
    for name, a in port_prog.buffers().items():
        np.testing.assert_allclose(got[name], a.numpy(), rtol=3e-6,
                                   atol=3e-7, err_msg=name)
    np.testing.assert_allclose(got["avg"],
                               port_prog.statistics().average_luminance.numpy(),
                               rtol=1e-4)
    s = _port()
    s.restore(ck)
    s.render_progressive(8)
    np.testing.assert_allclose(s.buffers()["beauty"].numpy(), got["beauty"],
                               rtol=3e-6, atol=3e-7)


def test_session_defaults_to_the_card():
    """No device means the card, and without one the session raises (no
    fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    scene, cam, env, cfg = _parts(TBuilder, tcam, tenv, tint)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsession.RenderSession(scene, cam, env, cfg)
