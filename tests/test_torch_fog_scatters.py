"""The fused pool's count of path segments that end in a medium (the
stats' "scatters") on the CPU: K3's plain version against a recount of its
volume test, the pool's stats with and without fog, the process-wide
totals, and the route of the benchmark's fog Cornell cell at its full
size. The scene is that cell's (`benchmark/configs/cornell_smoke.*`): six
boxes and two box media of density 0.01. The card's kernel against the
plain count: tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness
from raytracer_project_tpu_torch.core import rng, vecmath
from raytracer_project_tpu_torch.core.constants import T_MAX, T_MIN
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.models.scene import SceneBuilder
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator

torch.set_num_threads(2)

CELL = "cornell_smoke.final"
W, H = 12, 12


@pytest.fixture(scope="module")
def cornell():
    """(scene, environment, cell) of the benchmark's fog Cornell box."""
    cell = harness.load_cell(CELL)
    b = SceneBuilder()
    cell.generator.build(b, cell.cfg)
    e = dict(cell.cfg["environment"])
    e.pop("mode")
    return b.build(with_bvh=False), tenv.make_environment(**e), cell


def _config(cell, **kw):
    return integrator.RenderConfig(
        width=W, height=H, samples_per_pixel=2,
        max_depth=int(cell.cfg["render"]["max_depth"]),
        env_mode=tenv.SOLID_COLOR, use_albedo=False, use_normal=False,
        use_z_depth=False, **kw)


def _camera(cell, w=W, h=H):
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cell.cfg["camera"].items()}
    return tcam.make_camera(image_width=w, image_height=h, **kw)


def _vol_take(vparams, o, d, hit, t_hit, lr):
    """The lanes whose segment ends in one of the box media `vparams`
    (f32[V, 16]), recounted with the plain step's arithmetic: the slab span
    clamped by T_MIN and the surface hit, an exponential free flight from
    the lane's volume stream (salt v + 1), the nearest scatter kept."""
    best = torch.where(hit, t_hit, T_MAX)
    taken = torch.zeros_like(hit)
    ray_len = vecmath.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = [1.0 / torch.where(torch.abs(d[k]) < 1e-20,
                             torch.where(d[k] < 0, -1e-20, 1e-20), d[k])
           for k in range(3)]
    for v, vp in enumerate(vparams):
        assert float(vp[tfs._VP_KIND]) == 1.0      # a box
        t0 = [(vp[tfs._VP_BMIN + k] - o[k]) * inv[k] for k in range(3)]
        t1 = [(vp[tfs._VP_BMAX + k] - o[k]) * inv[k] for k in range(3)]
        entry = torch.stack([torch.minimum(a, b) for a, b in zip(t0, t1)]).amax(0)
        exit_ = torch.stack([torch.maximum(a, b) for a, b in zip(t0, t1)]).amin(0)
        e = torch.clamp(entry, min=T_MIN)
        x = torch.minimum(exit_, best)
        u = rng.draw_uniform(lr, rng.STREAM_VOLUME, salt=v + 1)
        flight = vp[tfs._VP_NID] * torch.log(torch.clamp(u, min=1e-38))
        t_v = e + flight / torch.clamp(ray_len, min=1e-20)
        take = ((entry < exit_) & (e < x) & (flight <= (x - e) * ray_len)
                & (t_v < best))
        best = torch.where(take, t_v, best)
        taken = taken | take
    return taken


def test_plain_scatter_count_is_the_sum_of_its_vol_take(cornell):
    """One step of K3's plain version on 8,192 lanes of rays inside the box
    (85% live, bounces 0-12): the count it adds equals the live lanes of
    the recounted volume test, a few hundred of them, and passing the count
    changes no output of the step."""
    scene, env, cell = cornell
    tables = tfs.build_tables(scene, env, tenv.SOLID_COLOR)
    p, n_pix, spp = 8192, 40 * 40, 4
    r = np.random.default_rng(5)
    o = r.uniform(10.0, 545.0, (3, p)).astype(np.float32)
    d = r.normal(size=(3, p)).astype(np.float32)
    od = torch.as_tensor(np.concatenate([o, d]))
    rec = tfs.trace_decode(tables, od, tfs._aparams(env, "cpu"))
    state_f = torch.as_tensor(np.concatenate(
        [o, d, r.uniform(0.0, 1.0, (3, p)), r.uniform(0.0, 2.0, (3, p))]
    ).astype(np.float32))
    live = r.random(p) < 0.85
    state_i = torch.as_tensor(np.stack(
        [live, r.integers(0, 13, p), r.integers(0, spp, p),
         r.integers(0, n_pix, p)]).astype(np.int32))
    cam = _camera(cell, 40, 40)
    sp = tfs.StepParams(
        seed=0x2545F491, sample_offset=0, n_pixels=n_pix, width=40,
        total_work=n_pix * spp, max_depth=50, env_mode=tenv.SOLID_COLOR,
        aux=0, z_max=50.0, aovs=(), use_reflection=False,
        use_refraction=False, n_beauty=n_pix * spp,
        n_volumes=scene.volumes.count)
    args = (tables, rec, state_f, state_i,
            torch.tensor([n_pix * spp - 500], dtype=torch.int32),
            torch.tensor([7], dtype=torch.int64), tfs._bparams(cam, env, "cpu"),
            sp)
    scatters = torch.tensor([11], dtype=torch.int64)
    out = tfs.shade_advance_plain(*args, scatters)
    lr = rng.LaneRng(sp.seed, rng.u32(state_i[3]), rng.u32(state_i[2]),
                     rng.u32(state_i[1]) << 1)
    taken = _vol_take(tables.vparams[:sp.n_volumes], od[:3], od[3:],
                      rec[tfs._RO_HIT] > 0.5, rec[tfs._RO_T], lr)
    want = int((torch.as_tensor(live) & taken).sum())
    assert int(scatters) - 11 == want
    assert 100 < want < int(live.sum())
    for a, b in zip(out, tfs.shade_advance_plain(*args)):
        assert torch.equal(a, b)


def test_pool_stats_count_scatters_in_fog_and_none_without(cornell,
                                                           monkeypatch):
    """render_pool_fused's stats: scatters > 0 in the fog Cornell box and
    0 in the showcase without fog; with the count dropped from K3's plain
    step (`shade_advance_plain` called without it) the pixels and the
    segments are the same as with it."""
    scene, env, cell = cornell
    cam, cfg = _camera(cell), _config(cell)
    out, st = tfs.render_pool_fused(scene, cam, env, 3, cfg, 2,
                                    with_stats=True)
    assert 0 < st["scatters"] < st["segments"]

    inner = tfs.shade_advance_plain
    monkeypatch.setattr(tfs, "shade_advance_plain",
                        lambda *a: inner(*a[:8]))
    out0, st0 = tfs.render_pool_fused(scene, cam, env, 3, cfg, 2,
                                      with_stats=True)
    monkeypatch.undo()
    assert st0["scatters"] == 0
    assert (st0["segments"], st0["steps"]) == (st["segments"], st["steps"])
    for a, b in zip(out, out0):
        assert torch.equal(a, b)

    clear = presets.showcase_scene(grid=2, with_meshes=False, with_bvh=False)
    sun = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cam2 = tcam.make_camera(image_width=W, image_height=H, vfov=30.0,
                            lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    cfg2 = dataclasses.replace(cfg, max_depth=4, env_mode=tenv.PHYSICAL_SUN)
    _, st2 = tfs.render_pool_fused(clear, cam2, sun, 3, cfg2, 2,
                                   with_stats=True)
    assert st2["segments"] > 0 and st2["scatters"] == 0


def test_process_totals_grow_by_each_calls_stats(cornell):
    """render_pool_fused.segments and .scatters add the stats of each call
    that reads them, through every caller (the integrator's pool route
    too), and a call without stats adds nothing."""
    scene, env, cell = cornell
    cam, cfg = _camera(cell), _config(cell)
    pool = tfs.render_pool_fused
    seg0, sc0 = pool.segments, pool.scatters
    _, a = tfs.render_pool_fused(scene, cam, env, 1, cfg, 2, with_stats=True)
    _, b = integrator.accumulate_samples(scene, cam, env, 2, cfg,
                                         with_stats=True)
    assert b["engine"] == "fused" and b["scatters"] > 0
    assert pool.segments == seg0 + a["segments"] + b["segments"]
    assert pool.scatters == sc0 + a["scatters"] + b["scatters"]
    tfs.render_pool_fused(scene, cam, env, 1, cfg, 2)
    assert (pool.segments, pool.scatters) == (
        seg0 + a["segments"] + b["segments"], sc0 + a["scatters"] + b["scatters"])


def test_the_cells_full_size_takes_the_fused_pool(cornell):
    """At the cell's own size (600x600, updates of 8 spp, depth 50) one
    update fits one fused pool call, so the session's updates take the fused
    pool (checked without rendering)."""
    scene, env, cell = cornell
    t = cell.traffic
    assert (t["width"], t["height"], t["update_spp"]) == (600, 600, 8)
    cfg = integrator.RenderConfig(
        width=t["width"], height=t["height"], samples_per_pixel=t["update_spp"],
        max_depth=50, env_mode=tenv.SOLID_COLOR, use_albedo=False,
        use_normal=False, use_z_depth=False)
    assert tfs.fused_spp_chunk(scene, cfg, env) >= 8
    assert tfs.fused_supported(scene, cfg, env)
    assert scene.volumes.count == 2
