"""A frame over several devices at once on the CPU (parallel/render.py's
window threads, parallel/distributed.py's devices, owners and groups):
the threaded windows against the same windows rendered one at a time, the
one-device render and the reference's sharded render over 4 virtual CPU
devices; an exception in a window; two gloo ranks with two windows each;
the per-rank cards and the group's backend, with torch.cuda stood in for."""

import sys
import threading

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.parallel import distributed
from raytracer_project_tpu_torch.parallel import render as prender
from raytracer_project_tpu_torch.utils.session import RenderSession

torch.set_num_threads(2)

# The reference's shard-invariance tolerance (tests/test_parallel.py:57-63).
SHARD_TOL = dict(rtol=3e-6, atol=3e-7)
SEED = 7


def _parts(builder, cam_mod, env_mod, int_mod):
    """25x15 @ 2 spp (375 pixels: 4 windows of 94, one padding slot)."""
    b = builder()
    ground = b.materials.lambertian("g", (0.5, 0.5, 0.5))
    metal = b.materials.metal("m", (0.9, 0.8, 0.7), fuzz=0.2)
    glass = b.materials.dielectric("d", 1.5)
    light = b.materials.diffuse_light("l", (4.0, 4.0, 4.0))
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.geometry.add_sphere((-1.2, 0.5, 0.0), 0.5, metal)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.geometry.add_box((0.8, 0.0, -0.4), (1.6, 1.2, 0.4), light)
    cfg = int_mod.RenderConfig(width=25, height=15, samples_per_pixel=2,
                               max_depth=5, env_mode=env_mod.SOLID_COLOR)
    cam = cam_mod.make_camera(image_width=25, image_height=15, vfov=40.0,
                              lookfrom=(0.0, 1.5, 4.0),
                              lookat=(0.0, 0.5, 0.0))
    env = env_mod.make_environment(background_color=(0.7, 0.8, 1.0))
    return b.build(), cam, env, cfg


def _setup():
    return _parts(TBuilder, tcam, tenv, tint)


def _serial_windows(scene, cam, env, cfg, n_windows):
    """The windows of a mesh of n_windows, rendered one after another in
    this thread: (sums, segments)."""
    ids = prender._padded_pixel_ids(cfg.n_pixels, n_windows)
    n_local = ids.shape[0] // n_windows
    parts, segments = [], 0
    for i in range(n_windows):
        buf, st = tint.accumulate_samples(
            scene, cam, env, SEED, cfg, None, 0, with_stats=True,
            pixel_offset=i * n_local, n_pixels_local=n_local)
        parts.append(buf)
        segments += st["segments"]
    return tint.SampleBuffers(*(torch.cat(x) for x in zip(*parts))), segments


def test_threaded_windows_equal_serial_windows_and_the_frame():
    """cpu x 4: every buffer of the threaded windows bit-equal to the four
    windows rendered one at a time, and within the reference's shard
    tolerance of the one-device render; segments equal."""
    scene, cam, env, cfg = _setup()
    n = cfg.n_pixels
    ids = prender._padded_pixel_ids(n, 4)
    acc, st = prender.sharded_accumulate(
        scene, cam, env, SEED, cfg, ids, 0,
        mesh=prender.make_mesh(4, device="cpu"), with_stats=True)
    serial, segments = _serial_windows(scene, cam, env, cfg, 4)
    for name, a, b in zip(acc._fields, acc, serial):
        assert torch.equal(a, b), name
    assert st["segments"] == segments
    single = tint.accumulate_samples(scene, cam, env, SEED, cfg)
    for name, a, b in zip(acc._fields, acc, single):
        np.testing.assert_allclose(a[:n].numpy(), b.numpy(), **SHARD_TOL,
                                   err_msg=name)


def test_windows_run_at_once(monkeypatch):
    """Every window's accumulate_samples waits at one barrier of 4 before
    rendering: only windows that run at once get past it. Each ran in a
    thread of its own, none in the caller's."""
    scene, cam, env, cfg = _setup()
    barrier = threading.Barrier(4, timeout=60)
    threads = []
    orig = tint.accumulate_samples

    def spy(*args, **kw):
        threads.append(threading.get_ident())
        barrier.wait()
        return orig(*args, **kw)

    monkeypatch.setattr(tint, "accumulate_samples", spy)
    img = prender.render_sharded(scene, cam, env, SEED, cfg,
                                 prender.make_mesh(4, device="cpu"))
    assert len(set(threads)) == 4
    assert threading.get_ident() not in threads
    assert bool(torch.isfinite(img["beauty"]).all())


def test_a_failing_window_raises_in_the_caller(monkeypatch):
    """Window 2's accumulate_samples raises: the call raises that error with
    the window named in its notes, after the other windows have run."""
    scene, cam, env, cfg = _setup()
    n_local = prender._padded_pixel_ids(cfg.n_pixels, 4).shape[0] // 4
    calls = []
    orig = tint.accumulate_samples

    def failing(*args, pixel_offset=0, **kw):
        calls.append(pixel_offset)
        if pixel_offset == 2 * n_local:
            raise ValueError("window failed on purpose")
        return orig(*args, pixel_offset=pixel_offset, **kw)

    monkeypatch.setattr(tint, "accumulate_samples", failing)
    with pytest.raises(ValueError, match="on purpose") as info:
        prender.render_sharded(scene, cam, env, SEED, cfg,
                               prender.make_mesh(4, device="cpu"))
    assert "window 2 of 4 on cpu" in info.value.__notes__
    assert sorted(calls) == [i * n_local for i in range(4)]


def test_threaded_frame_matches_the_reference_sharded_render():
    """The threaded 4-window frame against the reference's render_sharded
    (under jax.jit) over 4 of the conftest's virtual CPU devices: every
    buffer under the tie-robust rule of tests/test_torch_parallel.py:38
    (mean |d| < 1e-3, at most 0.5% of values over 3e-3)."""
    import jax

    from raytracer_project_tpu.models import camera as jcam
    from raytracer_project_tpu.models import environment as jenv
    from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
    from raytracer_project_tpu.ops import integrator as jint
    from raytracer_project_tpu.parallel import render as jrender

    scene, cam, env, cfg = _setup()
    got = prender.render_sharded(scene, cam, env, SEED, cfg,
                                 prender.make_mesh(4, device="cpu"))
    jscene, jc, je, jcfg = _parts(JBuilder, jcam, jenv, jint)
    ref = jrender.render_sharded_jit(jcfg, jrender.make_mesh(4))(
        jscene, jc, je, jax.random.PRNGKey(SEED))
    for name, img in got.items():
        d = np.abs(img.numpy() - np.asarray(ref[name]))
        assert d.mean() < 1e-3, (name, d.mean())
        assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())


def _rank_worker(rank, world, init_file, out_path):
    torch.set_num_threads(1)
    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=f"file://{init_file}",
                                        device="cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        scene, cam, env, cfg = _setup()
        mesh, owners = distributed.make_global_mesh(
            distributed.local_devices("cpu", per_process=2))
        img = distributed.render_distributed(scene, cam, env, SEED, cfg,
                                             device="cpu", per_process=2)
        ids = np.arange(cfg.n_pixels)
        mine = distributed.local_shard(ids, owners)
        sess = RenderSession(scene, cam, env, cfg, key=SEED, chunk_samples=1,
                             mesh=mesh, owners=owners)
        sess.render_progressive(cfg.samples_per_pixel)
        buffers = sess.buffers()
        stats = sess.statistics()
        if distributed.is_host0():
            np.savez(out_path, owners=np.asarray(owners), n_mesh=len(mesh),
                     rows=sess.acc.beauty.shape[0], first=mine[0],
                     avg=stats.average_luminance.numpy(),
                     hist=stats.histogram.numpy(),
                     **{k: v for k, v in img.items()},
                     **{f"session_{k}": v.numpy() for k, v in buffers.items()})
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_of_two_windows_match_one_process(tmp_path):
    """2 spawned gloo ranks with 2 CPU windows each: a global mesh of 4
    entries owned by [0, 0, 1, 1]; render_distributed's frame bit-equal to
    the one-process render over cpu x 4 and within the shard tolerance of
    the one-device render; a session over the same mesh (two windows a
    rank, 1 spp chunks) holds 188 rows on rank 0, equals that frame, and
    its statistics over the group are the frame's."""
    out = str(tmp_path / "out.npz")
    ctx = mp.start_processes(_rank_worker,
                             args=(2, str(tmp_path / "init"), out),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(240):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail("the ranks did not finish within 240 s")
    got = np.load(out)
    assert got["owners"].tolist() == [0, 0, 1, 1] and int(got["n_mesh"]) == 4
    assert int(got["rows"]) == 2 * 94 and int(got["first"]) == 0
    scene, cam, env, cfg = _setup()
    four = prender.render_sharded(scene, cam, env, SEED, cfg,
                                  prender.make_mesh(4, device="cpu"))
    single = tint.render(scene, cam, env, SEED, cfg, device="cpu")
    for name, img in four.items():
        np.testing.assert_array_equal(got[name], img.numpy(), err_msg=name)
        np.testing.assert_allclose(got[name], single[name].numpy(),
                                   **SHARD_TOL, err_msg=name)
        np.testing.assert_allclose(got[f"session_{name}"], img.numpy(),
                                   **SHARD_TOL, err_msg=name)
    whole = tpost.analyze_framebuffer(four["beauty"])
    np.testing.assert_allclose(got["avg"], whole.average_luminance.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["hist"], whole.histogram.numpy())


@pytest.fixture
def cards(monkeypatch):
    """torch.cuda standing in for a node of 4 cards, outside any group."""
    for name in ("LOCAL_RANK", "RANK", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    return monkeypatch


@pytest.mark.parametrize("local_rank, per_process, want", [
    (None, 1, [0]), (1, 1, [1]), (3, 1, [3]), (0, 2, [0, 1]), (1, 2, [2, 3]),
    (0, 4, [0, 1, 2, 3])])
def test_local_devices_gives_each_rank_its_cards(cards, local_rank,
                                                 per_process, want):
    """By default, the per_process cards from LOCAL_RANK * per_process."""
    if local_rank is not None:
        cards.setenv("LOCAL_RANK", str(local_rank))
    expect = [torch.device("cuda", i) for i in want]
    assert distributed.local_devices(per_process=per_process) == expect
    assert distributed.local_devices("cuda", per_process) == expect


def test_local_devices_raises_past_the_node_and_repeats_a_named_device(cards):
    """Too few cards raises; a device with an index, or the CPU, repeats."""
    cards.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="the node has 4"):
        distributed.local_devices(per_process=2)
    assert distributed.local_devices("cuda:0", 2) == [torch.device("cuda", 0)] * 2
    assert distributed.local_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_local_devices_raises_without_cuda(monkeypatch):
    """No CUDA: the default raises (no fallback to the CPU), as does a
    named card; device="cpu" gives the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.local_devices(device)
    assert distributed.local_devices("cpu") == [torch.device("cpu")]


@pytest.fixture
def groups(monkeypatch):
    """init_process_group recorded instead of run, the environment empty."""
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    made = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: made.append(dict(kw,
                                                               backend=backend)))
    return monkeypatch, made


def test_init_distributed_reads_torchrun_and_the_reference_variables(groups):
    """torchrun's variables make a group; the reference's win over them."""
    env, made = groups
    for k, v in dict(MASTER_ADDR="node0", MASTER_PORT="29500",
                     WORLD_SIZE="4", RANK="3").items():
        env.setenv(k, v)
    assert distributed.init_distributed(device="cpu")
    assert made[-1] == dict(backend="gloo", init_method="tcp://node0:29500",
                            world_size=4, rank=3)
    for k, v in dict(COORDINATOR_ADDRESS="host:1234", NUM_PROCESSES="2",
                     PROCESS_ID="1").items():
        env.setenv(k, v)
    assert distributed.init_distributed(device="cpu")
    assert made[-1] == dict(backend="gloo", init_method="tcp://host:1234",
                            world_size=2, rank=1)
    env.setenv("NUM_PROCESSES", "1")
    assert not distributed.init_distributed(device="cpu")
    assert len(made) == 2


def test_init_distributed_picks_nccl_for_the_card(groups):
    """The default backend: NCCL on the card, gloo on the CPU, gloo when
    asked for (two ranks sharing one card); without CUDA and no device
    given it raises rather than render on the CPU."""
    env, made = groups
    kw = dict(coordinator_address="host:1", num_processes=2, process_id=0)
    env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init_distributed(**kw)
    assert not made
    env.setattr(torch.cuda, "is_available", lambda: True)
    distributed.init_distributed(**kw)
    distributed.init_distributed(**kw, device="cuda:1")
    distributed.init_distributed(**kw, backend="gloo")
    distributed.init_distributed(**kw, device="cpu")
    assert [m["backend"] for m in made] == ["nccl", "nccl", "gloo", "gloo"]


def test_host_turns_hand_the_host_over_while_a_pool_waits():
    """Two window threads taking turns at the host: the second gets its
    turn only while the first waits on its card (fused_step._wait), and
    the first carries on once the second's turn is over."""
    turns, order = tfs.HostTurns(), []
    first_in, second_in = threading.Event(), threading.Event()

    class Event:
        def synchronize(self):
            assert second_in.wait(timeout=30)

    def first():
        with turns.held():
            order.append("first")
            first_in.set()
            tfs._wait(Event())
            order.append("first again")

    def second():
        assert first_in.wait(timeout=30)
        with turns.held():
            order.append("second")
            second_in.set()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert order == ["first", "second", "first again"]
    assert not turns._lock.locked()


def test_launch_counts_are_exact_under_threads():
    """kernels.count from more threads than cores, the interpreter switching
    threads every microsecond: no count is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.count(wrapper) for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per
