"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

With the smoke gate (`python -m raytracer_project_tpu_torch.utils.smoke`)
these are the card's checks; chip_smoke.py only times the kernels.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.bench import FUNNEL_CAM
from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import fused_step as fs
from raytracer_project_tpu_torch.ops import integrator
from raytracer_project_tpu_torch.ops import intersect, step_graphs, traverse
from raytracer_project_tpu_torch.tools import agree, diff_cases, goldens
from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
from raytracer_project_tpu_torch.tools import probe_decode as pd
from raytracer_project_tpu_torch.tools import probe_onehot as po

torch.set_num_threads(2)

CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0,
              hdr_image=HDR, hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1)
P = 65536


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(cuda):
    """Showcase tables on the card and a batch of camera-like and
    bounce-like rays made with numpy from a seed."""
    scene = presets.showcase_scene().to(cuda)
    env = tenv.make_environment(**ENV_KW)
    r = np.random.default_rng(0)
    m = P // 2
    o = np.concatenate([np.tile(np.float32([12.0, 2.5, 6.0]), (m, 1)),
                        np.stack([r.uniform(-8, 8, m), r.uniform(0.05, 3, m),
                                  r.uniform(-8, 8, m)], 1)])
    look = np.stack([r.uniform(-4, 4, m), r.uniform(-1, 3, m),
                     r.uniform(-4, 4, m)], 1)
    d = np.concatenate([look - o[:m], r.normal(size=(m, 3))])
    od = torch.as_tensor(np.ascontiguousarray(
        np.concatenate([o.T, d.T]), dtype=np.float32)).to(cuda)
    return scene, env, od


@pytest.mark.cuda
def test_closest_hit_kernel_matches_plain(inputs):
    scene, env, od = inputs
    tables = fs.build_tables(scene, env.to(od.device), tenv.PHYSICAL_SUN)
    agree.hit_budgets(k1.closest_hit(od, 1e-3, tables.scan),
                      k1.closest_hit_plain(od, 1e-3, tables.scan.coeffs,
                                           tables.scan.counts))


@pytest.fixture(scope="module")
def path_rays(cuda):
    """The showcase and the rays of the main path's pool: the camera rays
    of its first 131,072 lanes (800x450 @ 32 spp, seed 0) and, one plain
    step on, its bounce rays, f32[6, 131072] each."""
    scene = presets.showcase_scene().to(cuda)
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **CAM_KW).to(cuda)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    n, p = 800 * 450, 131_072
    sp = fs.StepParams(seed=rng.seed_from_int(0), sample_offset=0,
                       n_pixels=n, width=800, total_work=n * 32,
                       max_depth=10, env_mode=tenv.PHYSICAL_SUN)
    w = torch.arange(p, device=cuda)
    li, samp = (w % n).to(torch.int32), (w // n).to(torch.int32)
    o, d = tcam.generate_rays_soa(cam, rng.LaneRng(
        sp.seed, rng.u32(li), rng.u32(samp), 0), li, 800)
    ones = torch.ones(p, device=cuda)
    state_f = torch.stack([*o, *d, ones, ones, ones, 0 * ones, 0 * ones,
                           0 * ones]).contiguous()
    state_i = torch.stack([torch.ones_like(li), torch.zeros_like(li), samp,
                           li]).contiguous()
    rec = fs.decode_plain(tables, state_f[:6], *k1.closest_hit_plain(
        state_f[:6], 1e-3, tables.scan.coeffs, tables.scan.counts),
        fs._aparams(env, cuda))
    step = fs.shade_advance_plain(
        tables, rec, state_f, state_i,
        torch.tensor([p], dtype=torch.int32, device=cuda),
        torch.zeros(1, dtype=torch.int64, device=cuda),
        fs._bparams(cam, env, cuda), sp)
    return scene, tables, {"camera": state_f[:6].contiguous(),
                           "bounce": step[0][:6].contiguous()}


@pytest.mark.cuda
@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_closest_hit_kernel_matches_brute_oracle_on_path_rays(path_rays,
                                                              rays):
    """K1 on the main path's camera and bounce rays against the exact
    brute-force oracle (intersect_brute) under the reference's budgets."""
    scene, tables, od = path_rays[0], path_rays[1], path_rays[2][rays]
    tk, ik, yk = k1.closest_hit(od, 1e-3, tables.scan)
    ob = intersect.intersect_brute(scene, od[:3].T.contiguous(),
                                   od[3:].T.contiguous(), 1e-3)
    assert int((tk < 1e30).sum()) > 0
    agree.hit_budgets((tk, ik, yk), (ob.t, ob.prim_idx, ob.prim_type))


@pytest.mark.cuda
@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP])
def test_decode_kernel_matches_plain(inputs, env_mode):
    scene, env, od = inputs
    tables = fs.build_tables(scene, env.to(od.device), env_mode)
    aparams = fs._aparams(env, od.device)
    hit = k1.closest_hit(od, 1e-3, tables.scan)
    out = fs.decode(tables, od, *hit, aparams)
    ref = fs.decode_plain(tables, od, *hit, aparams)
    assert out.shape[0] == fs._RO_ROWS
    agree.rows_agree(out, ref, agree.RECORD_INT_ROWS)


@pytest.mark.cuda
def test_closest_hit_feats_kernel_matches_plain(inputs):
    """K4 on the same rays as K1, from their prebuilt feature rows: the
    same budgets against its plain version, and against K1."""
    scene, env, od = inputs
    tables = fs.build_tables(scene, env.to(od.device), tenv.PHYSICAL_SUN)
    feats = intersect.ray_feature_rows(od[:3].T, od[3:].T).contiguous()
    k1.closest_hit_feats.launches = 0
    out = k1.closest_hit_feats(feats, 1e-3, tables.scan)
    assert k1.closest_hit_feats.launches == 1
    ref = k1.closest_hit_feats_plain(feats, 1e-3, tables.scan.coeffs,
                                     tables.scan.counts)
    agree.hit_budgets(out, ref)
    agree.hit_budgets(out, k1.closest_hit(od, 1e-3, tables.scan))


def _record_entries(monkeypatch):
    """The C entries launched from now on, in order."""
    seen = []
    real = kernels.launch
    monkeypatch.setattr(kernels, "launch",
                        lambda entry, *a: seen.append(entry) or real(entry, *a))
    return seen


def _plain_calls(monkeypatch):
    """The names of the plain versions (and of the dense scans) called from
    now on, each still run: a render on the card calls none of them."""
    calls = []
    for mod, name in ((k1, "closest_hit_plain"), (k1, "closest_hit_feats_plain"),
                      (k1, "closest_hit_dense"), (k1, "closest_hit_feats_dense"),
                      (fs, "decode_plain"), (fs, "shade_advance_plain"),
                      (fs, "shade_accumulate_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    return calls


def _synthetic_scene(n_s, n_t, n_b, seed, dev):
    """Small spheres, triangles and rotated boxes scattered in [-10, 10]^3,
    made with numpy from a seed (the first sphere the r=1000 ground)."""
    r = np.random.default_rng(seed)
    f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    center = r.uniform(-10, 10, (n_s, 3))
    center[0] = (0.0, -1010.0, 0.0)
    radius = r.uniform(0.05, 0.5, n_s)
    radius[0] = 1000.0
    sph = types.SimpleNamespace(center=f32(center), radius=f32(radius),
                                count=n_s)
    v0 = r.uniform(-10, 10, (n_t, 3))
    tri = types.SimpleNamespace(v0=f32(v0), e1=f32(r.normal(0, 0.5, (n_t, 3))),
                                e2=f32(r.normal(0, 0.5, (n_t, 3))), count=n_t)
    box = None
    if n_b:
        m = np.linalg.qr(r.normal(size=(n_b, 3, 3)))[0] * r.uniform(
            0.05, 0.4, (n_b, 1, 3))
        minv = np.linalg.inv(m)
        pos = r.uniform(-10, 10, (n_b, 3))
        ext = np.abs(m).sum(-1)
        box = types.SimpleNamespace(
            mat=np.zeros(n_b, np.int32), count=n_b, minv=f32(minv.reshape(n_b, 9)),
            trans=f32(-np.einsum("bij,bj->bi", minv, pos)),
            aabb_min=f32(pos - ext), aabb_max=f32(pos + ext))
    return types.SimpleNamespace(
        mm=intersect.build_mm_tables(sph, tri, box).to(dev), spheres=sph,
        triangles=tri, boxes=box)


@pytest.mark.cuda
def test_compact_scan_equals_dense(inputs):
    """K1 and K4 on the compact rows equal the dense 16-term entries (the
    first port's scan) in t, idx and type on every lane, bit for bit."""
    scene, _, od = inputs
    tables = k1.scan_tables(scene)
    dense = pa.scene_tables(scene)
    feats = intersect.ray_feature_rows(od[:3].T, od[3:].T).contiguous()
    assert torch.isfinite(feats).all()
    for new, ref in ((k1.closest_hit(od, 1e-3, tables),
                      k1.closest_hit_dense(od, 1e-3, *dense)),
                     (k1.closest_hit_feats(feats, 1e-3, tables),
                      k1.closest_hit_feats_dense(feats, 1e-3, *dense))):
        assert int((ref[0] < 1e30).sum()) > P // 4
        for a, b in zip(new, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [(1100, 1300, 1237), (700, 900, 0),
                                    (600, 0, 1030)],
                         ids=["ragged", "no_boxes", "no_triangles"])
def test_compact_scan_equals_dense_synthetic(cuda, counts):
    """A seeded scene with three 512-wide chunks per table and ragged
    counts (the two-stage ring wraps over 5-11 tiles of 128 rows per
    table), and scenes without boxes or triangles: K1 and K4 equal the
    dense entries on every lane with finite features. A few lanes carry an
    infinite or NaN direction: they run, and are left out."""
    scene = _synthetic_scene(*counts, seed=sum(counts), dev=cuda)
    tables = k1.scan_tables(scene)
    dense = pa.scene_tables(scene)
    r = np.random.default_rng(4)
    n = 20_011
    o = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:3] = [[np.inf, 0, 0], [np.nan, 1, 0], [0, -np.inf, 1]]
    o_t, d_t = torch.as_tensor(o).to(cuda), torch.as_tensor(d).to(cuda)
    od = torch.cat([o_t.T, d_t.T]).contiguous()
    feats = intersect.ray_feature_rows(o_t, d_t).contiguous()
    finite = torch.isfinite(feats[:13]).all(0)
    assert int((~finite).sum()) == 3
    ref = k1.closest_hit_dense(od, 1e-3, *dense)
    assert int((ref[0] < 1e30).sum()) > n // 10
    for entry, out, ref in (
            ("closest_hit_od", k1.closest_hit(od, 1e-3, tables), ref),
            ("closest_hit_feats", k1.closest_hit_feats(feats, 1e-3, tables),
             k1.closest_hit_feats_dense(feats, 1e-3, *dense))):
        for a, b in zip(out, ref):
            assert torch.equal(a[finite], b[finite]), entry


@pytest.mark.cuda
def test_compact_tables_refuse_what_they_cannot_hold(inputs):
    """On the card too, compaction raises on a nonzero outside the slot
    lists, and the wrapper raises on rows of the wrong shape."""
    scene, _, od = inputs
    mm = scene.mm
    bad = mm.tri_coeff.clone()
    bad[9, 0, 3] = 0.5
    with pytest.raises(ValueError, match="structural zero"):
        k1.scan_tables(scene._replace(mm=mm._replace(tri_coeff=bad)))
    tables = k1.scan_tables(scene)
    short = tables._replace(rows=(tables.rows[0][:-1],) + tables.rows[1:])
    with pytest.raises(ValueError, match="compact rows"):
        k1.closest_hit(od, 1e-3, short)


@pytest.mark.cuda
@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.SOLID_COLOR,
                                      tenv.HDR_MAP])
def test_shade_advance_kernel_matches_plain(inputs, env_mode):
    """A random path state on real hits; next_work leaves less work than
    there are free lanes, so the cap and the cross-block ranks both act."""
    scene, env, od = inputs
    dev = od.device
    tables = fs.build_tables(scene, env.to(dev), env_mode)
    hit = k1.closest_hit(od, 1e-3, tables.scan)
    rec = fs.decode(tables, od, *hit, fs._aparams(env, dev))
    r = np.random.default_rng(1)
    state_f = torch.cat([od, torch.as_tensor(
        r.uniform(0, 1.5, (6, P)).astype(np.float32)).to(dev)]).contiguous()
    state_i = torch.as_tensor(np.stack([
        (r.random(P) < 0.85), r.integers(0, 13, P), r.integers(0, 4, P),
        r.integers(0, 800 * 450, P)]).astype(np.int32)).to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    sp = fs.StepParams(seed=rng.seed_from_int(7), sample_offset=2,
                       n_pixels=800 * 450, width=800, total_work=800 * 450 * 4,
                       max_depth=10, env_mode=env_mode)
    args = (rec, state_f, state_i,
            torch.tensor([sp.total_work - 9000], dtype=torch.int32, device=dev),
            torch.tensor([11], dtype=torch.int64, device=dev),
            fs._bparams(cam, env, dev), sp)
    out = fs.shade_advance(tables, *args)
    agree.rows_agree(out, fs.shade_advance_plain(tables, *args))
    assert int(out[4]) == sp.total_work


@pytest.mark.cuda
def test_render_goes_through_the_kernels(cuda, monkeypatch):
    """The fused render launches the pool's start kernel, K1 and K3 fused,
    K1 on the compact rows only, and neither K2, the unfused K3, a plain
    version nor an index_add_."""
    from torch.profiler import ProfilerActivity, profile

    plain_calls = _plain_calls(monkeypatch)
    entries = _record_entries(monkeypatch)
    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=2,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False)
    for fn in (k1.closest_hit, fs.decode, fs.shade_advance,
               fs.shade_accumulate):
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, stats = integrator.render(scene, cam, env, 0, cfg,
                                       with_stats=True)
    assert out["beauty"].device.type == "cuda"
    assert k1.closest_hit.launches > 0 and fs.shade_accumulate.launches > 0
    assert fs.decode.launches == 0 and fs.shade_advance.launches == 0
    assert not [e.name for e in prof.events() if "index_add" in e.name]
    assert "decode_launch" not in entries
    assert (entries.count("shade_accumulate_launch")
            == entries.count("closest_hit_od") > 0)
    assert stats["steps"] > 0 and stats["segments"] > 0
    img = out["beauty"].cpu()
    assert torch.isfinite(img).all() and img.max() > 0
    assert "closest_hit_od" in entries and "pool_start_launch" in entries
    assert not [e for e in entries if e.endswith("_dense")]
    assert not plain_calls


# K3 fused on random path states over real hits: beauty with one lane per
# pixel under the sun, a solid sky and an HDR map, the variant with fog,
# every AOV and both passes, and a pixel window with spec lanes.
FUSED_CASES = ("beauty", "features", "window", "solid", "hdr")
FUSED_ENV_MODES = {"solid": tenv.SOLID_COLOR, "hdr": tenv.HDR_MAP}


def _fused_step_inputs(inputs, case):
    """(tables, hits, aparams, bparams, sp, state_f, state_i, next_work,
    segments) of one K3 fused step on the card at P lanes."""
    scene, env, od = inputs
    dev = od.device
    r = np.random.default_rng(3)
    features = case == "features"
    spec = case in ("features", "window")
    env_mode = FUSED_ENV_MODES.get(case, tenv.PHYSICAL_SUN)
    if features:
        scene = presets.showcase_scene(use_fog=True,
                                       fog_density=0.05).to(dev)
    tables = fs.build_tables(scene, env.to(dev), env_mode)
    n, poff = (100_000, 123_457) if case == "window" else (800 * 450, 0)
    # One lane per pixel, except the feature step: a beauty and a spec
    # lane for each pixel (their adds go to different channels).
    slots = (np.repeat(r.permutation(n)[:P // 2], 2) if features
             else r.permutation(n)[:P])
    rows_i = [r.random(P) < 0.85,
              np.where(r.random(P) < 0.4, 0, r.integers(1, 13, P)),
              r.integers(0, 4, P), poff + slots]
    nf = 12
    if spec:
        rows_i += [np.arange(P) % 2 if features else r.random(P) < 0.5,
                   r.random(P) < 0.3, r.random(P) < 0.3]
        nf = 15
    state_f = torch.cat([od, torch.as_tensor(r.uniform(
        0.2, 1.5, (nf - 6, P)).astype(np.float32)).to(dev)]).contiguous()
    state_i = torch.as_tensor(np.stack(rows_i).astype(np.int32)).to(dev)
    n_beauty = n * 4
    sp = fs.StepParams(
        seed=rng.seed_from_int(7), sample_offset=2, n_pixels=n, width=800,
        total_work=n_beauty * (2 if spec else 1), max_depth=10,
        env_mode=env_mode, aux=3, z_max=50.0,
        aovs=fs.AOVS if spec else (), use_reflection=spec,
        use_refraction=spec, n_beauty=n_beauty,
        n_volumes=scene.volumes.count if features else 0, pixel_offset=poff)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    hits = k1.closest_hit(od, 1e-3, tables.scan)
    return (tables, hits, fs._aparams(env, dev), fs._bparams(cam, env, dev),
            sp, state_f, state_i,
            torch.tensor([n_beauty - 9000], dtype=torch.int32, device=dev),
            torch.tensor([11], dtype=torch.int64, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_CASES)
def test_shade_accumulate_kernel_matches_plain(inputs, case):
    """K3 fused against its plain version (decode, unfused K3, index_add_
    of the finishing lanes) on the same inputs: the state and counters as
    K3's own test holds them (integers exact, floats within rtol/atol
    1e-5); the accumulator within 1e-5, each address getting at most one
    add in the step, and its dummy slots untouched. The feature step may
    flip a fog flight on an ulp of logf: such lanes are at most 0.5% of
    the pool, and their pixels are left out of the comparison."""
    tables, hits, aparams, bparams, sp, *state = _fused_step_inputs(inputs,
                                                                     case)
    _, acc = agree.fused_step(tables, hits, state, aparams, bparams, sp,
                              int(0.005 * P) if case == "features" else 0)
    assert bool((acc.abs().sum(1) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("size, pool", [((64, 36), None), ((128, 72), 8192)])
def test_fused_render_twice_on_card(cuda, size, pool):
    """The showcase at 8 spp rendered twice on the card: 64x36 with the
    default pool (4,096 lanes, above its 2,304 pixels: two samples of a
    pixel can finish in one step, and K3 fused adds them in no fixed
    order) and 128x72 with 8,192 lanes, at or below its 9,216 pixels.
    Whether the two renders are bit-identical is printed, not assumed;
    they agree within rtol/atol 3e-4 and trace the same segments."""
    w, h = size
    cam = tcam.make_camera(image_width=w, image_height=h, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=w, height=h, samples_per_pixel=8,
                                  pool_lanes=pool)
    scene = presets.showcase_scene().to(cuda)
    runs = [integrator.render(scene, cam, env, 0, cfg, with_stats=True)
            for _ in range(2)]
    (a, sa), (b, sb) = runs
    assert sa["segments"] == sb["segments"]
    for name in a:
        d = float((a[name] - b[name]).abs().max())
        print(f"{w}x{h} pool {pool or 'default'} {name}: bit-identical "
              f"{torch.equal(a[name], b[name])}, max |d| {d:.3g}")
        torch.testing.assert_close(a[name], b[name], rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_chunked_render_goes_through_k4(cuda, monkeypatch):
    """The chunked integrator on the card launches K4 for every closest hit
    and never runs a plain version; all six buffers come back finite, the
    normal AOV in [0, 1], and each holds the port's CPU render under the
    cross-backend budgets (mean |d| <= 0.06, <= 20% of pixels with a
    channel over 0.05)."""
    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=32, image_height=18, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=32, height=18, samples_per_pixel=2,
                                  use_reflection=True, use_refraction=True,
                                  wavefront=False)
    cpu = integrator.render(scene, cam, env, 0, cfg, device="cpu")
    plain_calls = _plain_calls(monkeypatch)
    entries = _record_entries(monkeypatch)
    k1.closest_hit_feats.launches = 0
    out, stats = integrator.render(scene, cam, env, 0, cfg, with_stats=True)
    assert not plain_calls
    assert k1.closest_hit_feats.launches > 2
    assert entries.count("closest_hit_feats") == k1.closest_hit_feats.launches
    assert not [e for e in entries if e.endswith("_dense")]
    assert stats["segments"] > 2 * 32 * 18
    for name, img in out.items():
        assert img.device.type == "cuda" and img.shape == (18, 32, 3), name
        assert torch.isfinite(img).all(), name
        d = np.abs(img.cpu().numpy() - cpu[name].numpy())
        assert d.mean() <= 0.06 and (d.max(-1) > 0.05).mean() <= 0.20, name
    assert out["beauty"].max() > 0 and out["normal"].min() >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP])
def test_shade_advance_features_kernel_matches_plain(inputs, env_mode):
    """K3's variant with fog, every AOV and both split passes: a random
    spec-lane state on real hits, 40% of the lanes at bounce 0, with the
    showcase fog sphere and a dense fog box. A lane may flip a fog flight
    on an ulp of the card's logf: such lanes are at most 0.5% of the pool;
    on every other lane integer rows and targets are equal and float rows
    within 1e-5 abs + 1e-5 rel."""
    scene, env, od = inputs
    dev = od.device
    fog = presets.showcase_scene(use_fog=True, fog_density=0.05).to(dev)
    tables = fs.build_tables(fog, env.to(dev), env_mode)
    box = torch.tensor([[1.0, 0, 0, 0, 0, -3.0, 0.0, -2.0, 2.0, 1.5, 3.0,
                         -1.0 / 0.3, 0.9, 0.6, 0.5, 0.0]], device=dev)
    tables = tables._replace(vparams=torch.cat([tables.vparams, box]))
    hit = k1.closest_hit(od, 1e-3, tables.scan)
    rec = fs.decode(tables, od, *hit, fs._aparams(env, dev))
    r = np.random.default_rng(2)
    state_f = torch.cat([od, torch.as_tensor(np.concatenate([
        r.uniform(0, 1.5, (6, P)), r.uniform(0.2, 1.0, (3, P))]).astype(
            np.float32)).to(dev)]).contiguous()
    state_i = torch.as_tensor(np.stack([
        r.random(P) < 0.85, np.where(r.random(P) < 0.4, 0, r.integers(1, 13, P)),
        r.integers(0, 4, P), r.integers(0, 800 * 450, P), r.random(P) < 0.5,
        r.random(P) < 0.3, r.random(P) < 0.3]).astype(np.int32)).to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    n_beauty = 800 * 450 * 4
    sp = fs.StepParams(seed=rng.seed_from_int(7), sample_offset=2,
                       n_pixels=800 * 450, width=800, total_work=2 * n_beauty,
                       max_depth=10, env_mode=env_mode, aux=3, z_max=50.0,
                       aovs=fs.AOVS, use_reflection=True,
                       use_refraction=True, n_beauty=n_beauty,
                       n_volumes=tables.vparams.shape[0])
    args = (rec, state_f, state_i,
            torch.tensor([n_beauty - 9000], dtype=torch.int32, device=dev),
            torch.tensor([11], dtype=torch.int64, device=dev),
            fs._bparams(cam, env, dev), sp)
    fs.shade_advance.features_launches = 0
    out = fs.shade_advance(tables, *args)
    assert fs.shade_advance.features_launches == 1
    ref = fs.shade_advance_plain(tables, *args)
    bad = agree.differing_lanes(out[:4], ref[:4])
    for lane in torch.nonzero(bad).flatten().tolist():
        print(f"lane {lane} differs: bounce {int(state_i[1, lane])}")
    assert float(bad.float().mean()) <= 0.005
    if not bool(bad.any()):
        assert all(torch.equal(a, b) for a, b in zip(out[4:], ref[4:]))
    assert int(out[5]) == int(ref[5])


@pytest.mark.cuda
def test_features_render_matches_cpu(cuda, monkeypatch):
    """The fog showcase at 64x36 @ 4 spp with every AOV and both passes,
    through the default fused pool on the card: the K3 features variant
    runs, no plain version does, and all six buffers agree with the port's
    CPU render under the cross-backend budgets (mean |d| <= 0.06, <= 20% of
    pixels with a channel over 0.05)."""
    scene = presets.showcase_scene(use_fog=True, fog_density=0.02)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=4,
                                  use_reflection=True, use_refraction=True)
    cpu = integrator.render(scene, cam, env, 0, cfg, device="cpu")
    plain_calls = []
    for mod, name in ((k1, "closest_hit_plain"), (fs, "decode_plain"),
                      (fs, "shade_advance_plain"),
                      (fs, "shade_accumulate_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain_calls.append(_n))
    fs.shade_accumulate.features_launches = 0
    card = integrator.render(scene, cam, env, 0, cfg)
    assert not plain_calls and fs.shade_accumulate.features_launches > 0
    for name, ref in cpu.items():
        img = card[name].cpu().numpy()
        d = np.abs(img - ref.numpy())
        assert np.isfinite(img).all(), name
        assert d.mean() <= 0.06 and (d.max(-1) > 0.05).mean() <= 0.20, name


@pytest.mark.cuda
def test_fused_albedo_matches_the_chunked_first_hits(cuda):
    """The fused pool with every feature at the main path's size (the fog
    showcase, 800x450 @ 32 spp, depth 10, both split passes): all six
    buffers finite and not zero, and the albedo AOV's mean within 2% of
    the first hits' of a chunked render of the frame (1 spp, depth 1), so
    a dimmed AOV would show."""
    scene = presets.showcase_scene(use_fog=True).to(cuda)
    cam = tcam.make_camera(image_width=800, image_height=450,
                           defocus_angle=0.0, focus_dist=10.0, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=800, height=450, samples_per_pixel=32,
                                  max_depth=10, use_reflection=True,
                                  use_refraction=True)
    fs.shade_accumulate.features_launches = 0
    out = integrator.render(scene, cam, env, 1, cfg)
    assert fs.shade_accumulate.features_launches > 0
    for name, img in out.items():
        assert torch.isfinite(img).all() and img.max() > 0, name
    ref = integrator.render(scene, cam, env, 1, dataclasses.replace(
        cfg, samples_per_pixel=1, max_depth=1, wavefront=False))
    want = float(ref["albedo"].mean())
    assert abs(float(out["albedo"].mean()) - want) <= 0.02 * want


# --- the kernel probes (raytracer_project_tpu_torch/tools) -----------------

def _showcase_bounce_rays(dev, size=128):
    """od f32[6, size^2]: one scatter of the showcase camera's rays, made
    by the chunked path's own functions."""
    from raytracer_project_tpu_torch.ops import shade

    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=size, image_height=size,
                           **CAM_KW).to(dev)
    pix = torch.arange(size * size, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, size)
    first = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    return scene, torch.cat([sc.origin.T, sc.direction.T]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", pa.VARIANTS)
def test_ablation_kernel_matches_plain(cuda, variant):
    """P1 (K1's compact-row scan) on 16,384 of the probe's rays against its
    plain version at the card's grouping (pa.compare's budgets); idx and
    type 0; `full` and `nocull` equal K1's t bit for bit."""
    scene = presets.showcase_scene().to(cuda)
    tables = k1.scan_tables(scene)
    od = pa.make_rays(16_384, 1, cuda)
    pa.ablate.launches = 0
    t, idx, typ = pa.ablate(od, 0.0, tables, variant)
    assert pa.ablate.launches == 1
    assert not idx.any() and not typ.any()
    ref = pa.ablate_plain(od, 0.0, tables.coeffs, tables.bounds,
                          tables.counts, variant)[0]
    stats = pa.compare(variant, t, ref)
    assert stats["ok"], stats
    if variant in ("full", "nocull"):
        assert agree.finite_t_equal(t, k1.closest_hit(od, 0.0, tables)[0], od)


@pytest.mark.cuda
def test_ablation_full_equals_k1_on_bounce_rays(cuda):
    """On 16,384 showcase bounce rays and 16,384 of the funnel's (spread
    over its frame) at tmin 1e-3, P1 `full` and `nocull` equal K1's t bit
    for bit on every lane with finite features."""
    funnel, _, fod, _ = _bvh_funnel_rays(cuda, n=16_384,
                                         step=800 * 450 // 16_384)
    for scene, od in (_showcase_bounce_rays(cuda), (funnel, fod)):
        tables = k1.scan_tables(scene)
        tk = k1.closest_hit(od, 1e-3, tables)[0]
        assert int((tk < 1e30).sum()) > od.shape[1] // 10
        for v in ("full", "nocull"):
            assert agree.finite_t_equal(pa.ablate(od, 1e-3, tables, v)[0], tk,
                                   od), v


@pytest.mark.cuda
@pytest.mark.parametrize("mode", tuple(po.MODES))
def test_onehot_fetch_kernel_matches_plain(cuda, mode):
    """P2/P4's fetch on a random table and indices in [-2, n_rows + 2):
    every output equal to the plain version's, bit for bit."""
    t, idx, table = po.make_inputs(1536, 65_536, bool(po.MODES[mode][1]),
                                   seed=2, device=cuda)
    po.onehot_fetch.launches = 0
    out = po.onehot_fetch(t, idx, table, 24, mode)
    assert po.onehot_fetch.launches == 1
    if po.MODES[mode][2]:
        assert out.shape == (24, 65_536)
    else:
        assert len(out) == 24
    agree.same_bits(out, po.onehot_fetch_plain(t, idx, table, 24, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [0, 1, 7, 24, 28, 29, 32])
@pytest.mark.parametrize("mode", tuple(po.MODES))
def test_onehot_fetch_kernel_matches_plain_in_place_and_staged(cuda, mode,
                                                               n_out):
    """The fetch kernel as its entry chooses, in place and with its table
    staged in shared memory, against the plain version, bit for bit, on
    65,537 lanes (not a multiple of a block) with rows outside the table,
    at output counts on both sides of the 28 columns."""
    t, idx, table = po.make_inputs(1536, 65_537, bool(po.MODES[mode][1]),
                                   seed=3, device=cuda)
    ref = po.onehot_fetch_plain(t, idx, table, n_out, mode)
    po.onehot_fetch.launches = 0
    outs = [po.onehot_fetch(t, idx, table, n_out, mode),
            po.onehot_fetch(t, idx, table, n_out, mode, staged=False)]
    if mode != "plain":
        outs.append(po.onehot_fetch(t, idx, table, n_out, mode, staged=True))
    assert po.onehot_fetch.launches == len(outs)
    for out in outs:
        agree.same_bits(out, ref)


@pytest.mark.cuda
def test_onehot_fetch_refuses_what_it_cannot_take(cuda):
    """A table off 16 B alignment, and a staged table larger than a
    block's shared memory (the CPU tests hold the other refusals)."""
    t, idx, table = po.make_inputs(1536, 1024, device=cuda)
    buf = torch.empty(1536 * 28 + 1, device=cuda)
    off = buf[1:].view(1536, 28)
    off.copy_(table)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        po.onehot_fetch(t, idx, off, 24, "col")
    big = po.make_inputs(4096, 1024, True, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        po.onehot_fetch(*big, 24, "tdot", staged=True)


@pytest.mark.cuda
def test_probe_kernels_keep_their_work_in_sass(cuda):
    """From the built libraries' SASS (cuobjdump) and ptxas' report: each
    P1 variant drops the work it ablates and only that (cheapepi keeps the
    dots, at least the 9 + 19 + 21 structural FMAs and the 7 of ray
    features 6-10; nodots keeps the epilogues' MUFU and drops the row
    copies, LDGSTS); P2/P4's fetch_kernel and P3's stage_kernel keep every
    lane's state out of local memory (no stack frame, STL or LDL)."""
    from raytracer_project_tpu_torch import tools

    kernels.build_all(names=("probe_a1_ablate", "probe_onehot",
                             "probe_decode"))
    code = tools.kernel_code("probe_a1_ablate", "tile_scan_kernel")
    ops = {v: next(o for n, (o, _) in code.items() if f"ILb1ELi{i}ELb1EE" in n)
           for i, v in enumerate(pa.VARIANTS)}
    dots = sum(map(len, (k for s in k1.SLOTS for k in s)))
    assert ops["cheapepi"].get("FFMA", 0) >= dots + 7
    assert ops["nodots"].get("MUFU", 0) >= ops["full"].get("MUFU", 0)
    assert ops["nodots"].get("FFMA", 0) < ops["full"].get("FFMA", 0)
    assert ops["nodots"].get("LDGSTS", 0) == 0 < ops["full"].get("LDGSTS", 0)
    for source, name in (("probe_onehot", "_Z12fetch_kernel"),
                         ("probe_decode", "_Z12stage_kernel")):
        found = {n: v for n, v in tools.kernel_code(source, "").items()
                 if n.startswith(name)}
        assert found, source
        for n, (o, res) in found.items():
            assert res[2] == 0 and not o.get("STL") and not o.get("LDL"), n


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_decode_stage_kernel_matches_plain(cuda, stage):
    """P3's stages on K1's hits of the showcase camera rays: flags, t, the
    material id and the fetched columns equal, the decoded floats within
    1e-5 abs + 1e-5 rel (K2's budget)."""
    tables, od, hit, _ = pd.camera_hits(65_536, cuda)
    pd.decode_stage.launches = 0
    out = pd.decode_stage(stage, tables, od, *hit)
    assert pd.decode_stage.launches == 1
    ref = pd.decode_stage_plain(stage, tables, od, *hit)
    assert out.shape[0] == fs._RO_ROWS
    agree.rows_agree(out, ref, agree.stage_exact_rows(stage))


# --- the scenes past the showcase and the BVH -----------------------------



@pytest.mark.cuda
def test_bvh_traversal_matches_brute_on_card(cuda):
    """The reference's bvh-traverse gate on the card: on
    bvh_stress_scene(n_spheres=9000), 512 camera rays of the funnel camera
    (128x72) find the same hit set by BVH traversal as by the brute-force
    oracle, t within rtol/atol 2e-4."""
    scene = presets.bvh_stress_scene(n_spheres=9000).to(cuda)
    cam = tcam.make_camera(image_width=128, image_height=72,
                           **FUNNEL_CAM).to(cuda)
    px = torch.as_tensor(np.random.default_rng(7).integers(0, 128 * 72, 512))
    px = px.to(cuda)
    lr = rng.lane_rng(rng.seed_from_int(8), px, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, px, 128)
    stats = {}
    hb = traverse.intersect_bvh(scene, o, d, 1e-3, stats)
    ho = intersect.intersect_brute(scene, o, d, 1e-3)
    assert hb.t.device.type == "cuda" and stats["iterations"] > 10
    assert torch.equal(hb.hit, ho.hit) and int(hb.hit.sum()) > 100
    torch.testing.assert_close(hb.t[hb.hit], ho.t[hb.hit], rtol=2e-4,
                               atol=2e-4)
    assert intersect.intersect_dispatch(scene, cuda) == "k4"


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["chunked", "fused"])
@pytest.mark.parametrize("name", goldens.NAMES)
def test_scene_golden_on_card(cuda, name, engine, monkeypatch):
    """The goldens past the showcase through integrator.render on the card,
    on either engine (K4, or K1-K3) with no plain version run, against the
    reference's CPU goldens under the cross-backend budgets."""
    plain_calls = _plain_calls(monkeypatch)
    scene, cam, env, cfg = goldens.golden_config(name)
    cfg = dataclasses.replace(cfg, wavefront=engine == "fused")
    counters = (((k1.closest_hit_feats, "launches"),) if engine == "chunked"
                else ((k1.closest_hit, "launches"),
                      (fs.shade_accumulate, "launches"),
                      (fs.shade_accumulate, "features_launches")))
    for fn, attr in counters:
        setattr(fn, attr, 0)
    img = integrator.render(scene, cam, env, 0, cfg)["beauty"].cpu().numpy()
    counts = [getattr(fn, attr) for fn, attr in counters]
    assert counts[0] > 0 and (engine == "chunked" or sum(counts[1:]) > 0)
    assert not plain_calls
    assert np.isfinite(img).all() and img.max() > 0
    mean, frac = goldens.golden_diff(img, name)
    assert mean <= 0.06 and frac <= 0.20, (mean, frac)


@pytest.mark.cuda
def test_closest_hit_matches_plain_on_funnel_bounce_rays(cuda):
    """K1 against its plain version on the funnel (25,091 primitives):
    65,536 bounce rays, one scatter of the funnel camera's rays. Near-origin
    hits (the primitive the ray leaves, or any hit within 0.02 of the
    origin: the funnel's spheres overlap) have a root that each
    formulation's rounding decides: they count in the 3% budget, not under
    the 5e-2 cap."""
    from raytracer_project_tpu_torch.ops import shade

    scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2).to(cuda)
    tables = intersect.hit_tables(scene)
    cam = tcam.make_camera(image_width=256, image_height=256,
                           **FUNNEL_CAM).to(cuda)
    pix = torch.arange(256 * 256, device=cuda)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 256)
    first = intersect.intersect(scene, o, d, 1e-3, tables)
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    od = torch.cat([sc.origin.T, sc.direction.T]).contiguous()
    got = k1.closest_hit(od, 1e-3, tables)
    want = k1.closest_hit_plain(od, 1e-3, tables.coeffs, tables.counts)
    assert int((got[0] < 1e30).sum()) > P // 10
    agree.hit_budgets(got, want, agree.near_origin(
        (first.prim_idx, first.prim_type, first.hit), got, want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_shade_advance_window_matches_plain(inputs, spec):
    """K3 on a pixel window (pixel_offset != 0): lanes carry global pixel
    ids in the window, the targets are their slots, respawned lanes stay in
    the window; the kernel equals its plain version."""
    scene, env, od = inputs
    dev = od.device
    tables = fs.build_tables(scene, env.to(dev), tenv.PHYSICAL_SUN)
    rec = fs.decode(tables, od, *k1.closest_hit(od, 1e-3, tables.scan),
                    fs._aparams(env, dev))
    n_local, poff = 50_000, 123_457
    r = np.random.default_rng(2)
    rows_i = [(r.random(P) < 0.85), r.integers(0, 13, P), r.integers(0, 4, P),
              poff + r.integers(0, n_local, P)]
    nf = 12
    if spec:
        rows_i += [r.random(P) < 0.5, r.random(P) < 0.3, r.random(P) < 0.3]
        nf = 15
    state_f = torch.cat([od, torch.as_tensor(r.uniform(
        0, 1.5, (nf - 6, P)).astype(np.float32)).to(dev)]).contiguous()
    state_i = torch.as_tensor(np.stack(rows_i).astype(np.int32)).to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    n_beauty = n_local * 4
    sp = fs.StepParams(seed=rng.seed_from_int(7), sample_offset=2,
                       n_pixels=n_local, width=800,
                       total_work=n_beauty * (2 if spec else 1), max_depth=10,
                       env_mode=tenv.PHYSICAL_SUN, aovs=fs.AOVS if spec else (),
                       aux=3, use_reflection=spec, use_refraction=spec,
                       n_beauty=n_beauty, pixel_offset=poff)
    args = (rec, state_f, state_i,
            torch.tensor([n_beauty - 9000], dtype=torch.int32, device=dev),
            torch.tensor([11], dtype=torch.int64, device=dev),
            fs._bparams(cam, env, dev), sp)
    out = fs.shade_advance(tables, *args)
    ref = fs.shade_advance_plain(tables, *args)
    for k, (a, b) in enumerate(zip(out, ref)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b), k
    tgt = out[3]
    assert bool(((tgt >= 0) & (tgt <= n_local)).all())
    assert bool((tgt < n_local).any())
    li = out[1][3]
    assert bool(((li >= poff) & (li < poff + n_local)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["fused", "pool", "chunked"])
def test_windows_sum_to_the_frame_on_card(cuda, engine, monkeypatch):
    """Three windows of one card (a frame of 2,501 pixels, two padding
    slots) sum to the one-window render: segments exactly those of the
    frame and its padding, sums within rtol/atol 3e-4 (the card's
    scatter-adds sum in no fixed order)."""
    from raytracer_project_tpu_torch.parallel import render as prender

    if engine == "pool":
        monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    scene = presets.showcase_scene().to(cuda)
    cam = tcam.make_camera(image_width=61, image_height=41, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=61, height=41, samples_per_pixel=4,
                                  use_reflection=True,
                                  wavefront=engine != "chunked")
    n = cfg.n_pixels
    full, fst = integrator.accumulate_samples(scene, cam, env, 5, cfg,
                                              with_stats=True)
    ids = prender._padded_pixel_ids(n, 3)
    acc, st = prender.sharded_accumulate(scene, cam, env, 5, cfg, ids, 0,
                                         mesh=prender.make_mesh(3, cuda),
                                         with_stats=True)
    pad = ids.shape[0] - n
    if engine == "fused":
        phantom = integrator.accumulate_samples(
            scene, cam, env, 5, cfg, pixel_offset=n, n_pixels_local=pad,
            with_stats=True)[1]["segments"]
    else:
        phantom = integrator.accumulate_samples(
            scene, cam, env, 5, cfg, torch.full((pad,), n - 1, device=cuda),
            with_stats=True)[1]["segments"]
    assert st["segments"] == fst["segments"] + phantom
    for name, a, b in zip(acc._fields, acc, full):
        torch.testing.assert_close(a[:n], b, rtol=3e-4, atol=3e-4, msg=name)


@pytest.mark.cuda
def test_unfused_pool_smoke_golden_on_card(cuda, monkeypatch):
    """The reference's pool-render stage on the card: 128x72 @ 4 spp
    through the unfused pool (K1 only, no plain version) against
    smoke_pool_128x72.npz under the cross-backend budgets 0.06 / 0.20."""
    monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    plain_calls = _plain_calls(monkeypatch)
    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=128, image_height=72,
                           defocus_angle=0.0, focus_dist=10.0, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=128, height=72, samples_per_pixel=4,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False)
    k1.closest_hit.launches = fs.shade_accumulate.launches = 0
    out, st = integrator.render(scene, cam, env, 0, cfg, with_stats=True)
    assert st["engine"] == "pool" and k1.closest_hit.launches > 0
    assert fs.shade_accumulate.launches == 0 and not plain_calls
    img = out["beauty"].cpu().numpy()
    golden = np.load(goldens.GOLDEN_DIR / "smoke_pool_128x72.npz")["beauty"]
    d = np.abs(img - golden)
    assert np.isfinite(img).all() and img.max() > 0
    assert d.mean() <= 0.06 and (d.max(axis=-1) > 0.05).mean() <= 0.20


@pytest.mark.cuda
def test_sort_rays_hits_equal_on_card(inputs):
    """sort_rays on the card: the same hits as the unsorted K4 route."""
    scene, _, od = inputs
    o, d = od[:3].T.contiguous(), od[3:].T.contiguous()
    tables = intersect.hit_tables(scene)
    a = intersect.intersect(scene, o, d, 1e-3, tables)
    b = intersect.intersect(scene, o, d, 1e-3, tables, sort_rays=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_intersect_detached_on_card(inputs):
    """The detached intersection on the card: K4 runs the search (one
    launch) on rays whose gradient matters; its hits and t (recomputed from
    the chosen primitives) hold the closest-hit budgets against the CPU's,
    and the
    gradients of sum(t) into the rays and the sphere centres, which come
    from the recomputed t, agree with the CPU's within 1e-4 of their
    largest entry wherever both searches chose the same primitive."""
    scene, _, od = inputs
    cpu_scene = presets.showcase_scene()
    res = {}
    for dev, sc in ((od.device, scene), (torch.device("cpu"), cpu_scene)):
        o = od[:3].T.contiguous().to(dev).requires_grad_(True)
        d = od[3:].T.contiguous().to(dev).requires_grad_(True)
        center = sc.spheres.center.detach().clone().requires_grad_(True)
        s = sc._replace(spheres=sc.spheres._replace(center=center))
        k1.closest_hit_feats.launches = 0
        h = intersect.intersect_detached(s, o, d, 1e-3, intersect.hit_tables(s))
        assert k1.closest_hit_feats.launches == (dev.type == "cuda")
        grads = torch.autograd.grad(torch.where(h.hit, h.t, 0.0).sum(),
                                    (o, d, center))
        res[dev.type] = [x.detach().cpu() for x in (h.t, h.prim_idx,
                                                    h.prim_type)], grads
    (tk, ik, yk), gk = res["cuda"]
    (tp, ip, yp), gp = res["cpu"]
    agree.hit_budgets((tk, ik, yk), (tp, ip, yp))
    same = (ik == ip) & (yk == yp) & (tk < 1e30) & (tp < 1e30)
    for a, b in zip(gk[:2], gp[:2]):
        a, b = a.cpu()[same], b[same]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    # Only the spheres every lane agrees on: centres of disagreeing
    # spheres take other lanes' gradients.
    bad = torch.zeros(cpu_scene.spheres.count, dtype=torch.bool)
    bad[torch.cat([ik[~same & (yk == 0)], ip[~same & (yp == 0)]]).long()] = True
    a, b = gk[2].cpu()[~bad], gp[2][~bad]
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    with pytest.raises(ValueError, match="detached"):
        feats = intersect.ray_feature_rows(
            od[:3].T.clone().requires_grad_(True), od[3:].T).contiguous()
        k1.closest_hit_feats(feats, 1e-3, intersect.hit_tables(scene))


@pytest.mark.cuda
def test_diff_render_and_unet_on_card(cuda, monkeypatch):
    """The differentiable render of the reference's tiny gradient scene on
    the card (K4 launched) against the CPU's, both free-running: at most
    2.5% of lanes hit another primitive on some search
    (diff_cases.search_agreement), and on the pixels whose every lane
    agrees the image holds to 1e-4 and the albedo gradient of the loss over
    them within 2e-3 of its largest entry; and the shipped U-Net (cuDNN,
    f32: TF32 off) against the CPU on seeded 37x53 buffers within 1e-4 of
    the output's largest value."""
    from raytracer_project_tpu_torch import diff
    from raytracer_project_tpu_torch.models import denoiser_unet

    search = intersect.intersect
    state, cfg = diff_cases.tiny_state(tenv.PHYSICAL_SUN)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        st = state.to(dev)
        albedo = st.scene.materials.albedo.detach().clone().requires_grad_(True)
        st = diff.apply_params(st, {"scene.materials.albedo": albedo})
        hits = []
        monkeypatch.setattr(intersect, "intersect", lambda *a, **k: hits.append(
            search(*a, **k)) or hits[-1])
        k1.closest_hit_feats.launches = 0
        img = diff.render_beauty(st, 0, cfg, device=dev)
        monkeypatch.setattr(intersect, "intersect", search)
        n = k1.closest_hit_feats.launches
        assert 1 <= n <= 4 if dev.type == "cuda" else n == 0
        runs[dev.type] = img, albedo, hits
    lanes, pixels = diff_cases.search_agreement(runs["cuda"][2], runs["cpu"][2],
                                                cfg.n_pixels)
    assert int((~lanes).sum()) <= 0.025 * lanes.numel()
    w = pixels.reshape(cfg.height, cfg.width, 1).float()
    out = {}
    for name, (img, albedo, _) in runs.items():
        wd = w.to(img.device)
        (g,) = torch.autograd.grad((img ** 2 * wd).sum(), albedo)
        out[name] = (img * wd).detach().cpu(), g.cpu()
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    gk, gp = out["cuda"][1], out["cpu"][1]
    assert float((gk - gp).abs().max()) <= 2e-3 * float(gp.abs().max())

    r = np.random.default_rng(3)
    bufs = [torch.from_numpy(r.uniform(0.0, 2.0, (37, 53, 3)).astype(np.float32))
            for _ in range(3)]
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        ref = denoiser_unet.load_default(device="cpu")(*bufs)
        got = denoiser_unet.load_default(device=cuda)(*(b.to(cuda) for b in bufs))
    assert torch.backends.cudnn.allow_tf32 == tf32   # the module restores it
    assert float((got.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


# --- the progressive session and the wireframe (utils/session.py,
# ops/debugviz.py) -------------------------------------------------------------

def _showcase_session(dev, width=64, height=36, spp=8):
    from raytracer_project_tpu_torch.utils.session import RenderSession

    cfg = integrator.RenderConfig(width=width, height=height,
                                  samples_per_pixel=spp)
    cam = tcam.make_camera(image_width=width, image_height=height, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    return RenderSession(presets.showcase_scene(), cam, env, cfg, key=0,
                         chunk_samples=2, device=dev)


def _tie_robust(name, got, want):
    """tests/test_torch_pool.py's rule: mean |d| < 1e-3 and at most 0.5% of
    values over 3e-3."""
    d = (got.cpu() - want).abs().numpy()
    assert d.mean() < 1e-3, (name, d.mean())
    assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())


def _k1_on_the_cpu(od, tmin, tables):
    """K1's hits from its plain version on the CPU, handed back to the card."""
    t, idx, typ = k1.closest_hit_plain(
        od.cpu(), tmin, tuple(c.cpu() for c in tables.coeffs), tables.counts)
    return t.to(od.device), idx.to(od.device), typ.to(od.device)


@pytest.mark.cuda
def test_session_on_card_matches_cpu(cuda, monkeypatch):
    """A 64x36 @ 8 spp showcase session in chunks of 2 (AOVs on) on the
    card: K1 and K3 fused launch and no plain version runs; every buffer equals the
    card's one-shot render up to float reassociation (rtol/atol 3e-4).
    Against the CPU session the card's K1 sums t in another order than its
    plain version, within the closest-hit budgets, so a few paths take
    other branches: on an H100 80GB HBM3 at 700 W beauty read mean |d|
    9.36e-4 with 1.45% of values over 3e-3 (45 of 2,304 pixels), where the
    tie-robust rule allows 0.5%. The limits here are about twice those
    readings: mean |d| < 2e-3 and at most 3% of values over 3e-3. The next
    test replays K1 on the CPU and holds the full rule."""
    cpu = _showcase_session("cpu")
    cpu.render_progressive(8)
    plain_calls = []
    for mod, name in ((k1, "closest_hit_plain"), (fs, "decode_plain"),
                      (fs, "shade_advance_plain"),
                      (fs, "shade_accumulate_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain_calls.append(_n))
    k1.closest_hit.launches = fs.shade_accumulate.features_launches = 0
    card = _showcase_session(cuda)
    card.render_progressive(8)
    assert not plain_calls
    assert k1.closest_hit.launches > 0
    assert fs.shade_accumulate.features_launches > 0
    one = integrator.render(card.scene, card.camera, card.env, 0, card.config)
    want = cpu.buffers()
    for name, img in card.buffers().items():
        torch.testing.assert_close(img, one[name], rtol=3e-4, atol=3e-4)
        d = (img.cpu() - want[name]).abs().numpy()
        assert np.isfinite(d).all(), name
        assert d.mean() < 2e-3, (name, d.mean())
        assert (d > 3e-3).mean() <= 0.03, (name, (d > 3e-3).mean())
        assert (d.max(-1) > 0.05).mean() <= 0.20, name
    assert card.display().shape == (36, 64, 3)


@pytest.mark.cuda
def test_session_on_card_with_k1_replayed_matches_cpu(cuda, monkeypatch):
    """The session above with K1's hits taken from its plain version on the
    CPU and K3 fused on the card: every buffer holds the CPU session's under
    the full tie-robust rule, so the free-running difference above comes
    from K1's summation order alone."""
    cpu = _showcase_session("cpu")
    cpu.render_progressive(8)
    monkeypatch.setattr(k1, "closest_hit", _k1_on_the_cpu)
    # A captured step cannot run K1 on the host: every call steps eagerly.
    monkeypatch.setattr(step_graphs.cache, "take", lambda *a: None)
    fs.shade_accumulate.features_launches = 0
    card = _showcase_session(cuda)
    card.render_progressive(8)
    assert fs.shade_accumulate.features_launches > 0
    want = cpu.buffers()
    for name, img in card.buffers().items():
        _tie_robust(name, img, want[name])
    assert card.segments_traced == cpu.segments_traced


@pytest.mark.cuda
def test_display_wire_on_card(cuda):
    """display_wire on the card runs K4 for the surface test, and the card's
    composite over a given beauty equals the CPU's except on pixels whose
    edge or surface test grazes (at most 0.2%)."""
    from raytracer_project_tpu_torch.ops import debugviz

    card = _showcase_session(cuda)
    card.step()
    k1.closest_hit_feats.launches = 0
    frame = card.display_wire(level=2, thickness=0.05)
    assert k1.closest_hit_feats.launches > 0
    assert frame.shape == (36, 64, 3) and frame.dtype == np.uint8
    beauty = card.buffers()["beauty"]
    cpu_scene = presets.showcase_scene()
    cam = card.camera.to("cpu")
    want = debugviz.composite_wireframe(cpu_scene, cam, beauty.cpu(), level=2,
                                        thickness=0.05)
    got = debugviz.composite_wireframe(card.scene, card.camera, beauty,
                                       level=2, thickness=0.05).cpu()
    assert bool((want != beauty.cpu()).any())
    assert float(((got - want).abs().amax(-1) > 1e-5).float().mean()) <= 0.002


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0.0, 1e-4])
def test_smoke_device_golden_bites(cuda, offset):
    """The smoke gate's tight check on this card: the committed device
    golden of the fused-fast frame names this card and CUDA version; an
    unchanged render passes it, and one with 1e-4 added to one channel of
    every pixel (mean |d| 3.3e-5, invisible to the cross-backend budgets)
    fails it."""
    from raytracer_project_tpu_torch.utils import smoke

    info = smoke.device_info(cuda)
    with np.load(smoke._golden_path("smoke_fused_64x36_cuda")) as g:
        assert (str(g["device"]), str(g["cuda"])) == (info.name, info.cuda)
    (name, label, max_frac, img), = smoke.render_fused_fast(cuda)
    img = img.copy()
    img[..., 0] += offset
    err = smoke._check_image(img, name, label, max_frac, device=info)
    if offset:
        assert err is not None and "drifted from device golden" in err
    else:
        assert err is None


def _window_frame(cuda, w=200, h=113, spp=8):
    scene = presets.showcase_scene().to(cuda)
    cam = tcam.make_camera(image_width=w, image_height=h, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=w, height=h, samples_per_pixel=spp)
    return scene, cam, env, cfg


@pytest.mark.cuda
def test_threaded_windows_on_card_equal_serial_windows(cuda):
    """Four windows of cuda:0, each in a thread of its own on a stream of
    its own, against the same four rendered one after another in this
    thread: segments equal, sums within rtol/atol 3e-4 (the card's
    accumulator adds in no fixed order), K1 launched by the windows."""
    from raytracer_project_tpu_torch.parallel import render as prender

    scene, cam, env, cfg = _window_frame(cuda)
    ids = prender._padded_pixel_ids(cfg.n_pixels, 4)
    n_local = ids.shape[0] // 4
    k1.closest_hit.launches = 0
    acc, st = prender.sharded_accumulate(
        scene, cam, env, 5, cfg, ids, 0, mesh=[torch.device("cuda", 0)] * 4,
        with_stats=True)
    assert k1.closest_hit.launches > 0
    parts, segments = [], 0
    for i in range(4):
        buf, wst = integrator.accumulate_samples(
            scene, cam, env, 5, cfg, with_stats=True, pixel_offset=i * n_local,
            n_pixels_local=n_local)
        parts.append(buf)
        segments += wst["segments"]
    assert st["segments"] == segments
    for name, a, *b in zip(acc._fields, acc, *parts):
        torch.testing.assert_close(a, torch.cat(b), rtol=3e-4, atol=3e-4,
                                   msg=name)


@pytest.mark.cuda
def test_one_rank_nccl_render_distributed(cuda, tmp_path):
    """A process group of one rank on NCCL: render_distributed (two windows
    of cuda:0, gathered on the card) against the one-process render within
    rtol/atol 3e-4, and the group's statistics reduced on the card against
    the frame's."""
    import torch.distributed as dist

    from raytracer_project_tpu_torch.ops import post
    from raytracer_project_tpu_torch.parallel import distributed

    scene, cam, env, cfg = _window_frame(cuda)
    one = integrator.render(scene, cam, env, 5, cfg)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'init'}",
                            world_size=1, rank=0)
    try:
        mesh, owners = distributed.make_global_mesh(
            distributed.local_devices("cuda:0", 2))
        assert owners == [0, 0] and len(mesh) == 2
        img = distributed.render_distributed(scene, cam, env, 5, cfg,
                                             device="cuda:0", per_process=2)
        stats = post.analyze_framebuffer_psum(one["beauty"].reshape(-1, 3))
    finally:
        dist.destroy_process_group()
    for name, a in one.items():
        np.testing.assert_allclose(img[name], a.cpu().numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=name)
    whole = post.analyze_framebuffer(one["beauty"])
    assert stats.histogram.device.type == "cuda"
    assert torch.equal(stats.histogram, whole.histogram)
    torch.testing.assert_close(stats.average_luminance,
                               whole.average_luminance, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_distinct_card_mesh(cuda):
    """Windows on distinct cards at once (every card of the machine)
    against the one-device render; needs two cards or more."""
    from raytracer_project_tpu_torch.parallel import render as prender

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"a mesh of distinct cards needs two; this machine has "
                    f"{count}")
    scene, cam, env, cfg = _window_frame(cuda)
    one = integrator.render(scene, cam, env, 5, cfg)
    got = prender.render_sharded(scene, cam, env, 5, cfg, prender.make_mesh())
    for name, a in one.items():
        torch.testing.assert_close(got[name], a, rtol=3e-4, atol=3e-4,
                                   msg=name)


@pytest.mark.cuda
def test_launch_on_another_current_device_raises(cuda, monkeypatch):
    """A kernel launched from a thread whose current device is not its
    tensors' raises before it launches (the kernels launch on the calling
    thread's device). With one card, current_device stands in for cuda:1."""
    scene = presets.showcase_scene().to(cuda)
    tables = k1.scan_tables(scene)
    od = torch.zeros((6, 256), device="cuda:0")
    od[4] = 1.0
    errors = []

    def run():
        if torch.cuda.device_count() >= 2:
            torch.cuda.set_device(1)
        try:
            k1.closest_hit(od, 1e-3, tables)
        except RuntimeError as e:
            errors.append(str(e))

    if torch.cuda.device_count() < 2:
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    k1.closest_hit.launches = 0
    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert errors and "current device is cuda:1" in errors[0], errors
    assert k1.closest_hit.launches == 0


# The pool's start in one launch: (pixels, spp, lanes, split passes on,
# pixel offset, sample offset). 90,000, 120,000, 100,000 and 1,000 lanes
# are not multiples of the 256-lane block; the spec case and the window
# start spec lanes.
START_CASES = {
    "turntable": (800 * 450, 4, 131_072, False, 0, 0),
    "preview": (400 * 225, 1, 90_000, False, 0, 7),
    "spec": (30_000, 2, 120_000, True, 0, 3),
    "window": (50_000, 1, 100_000, True, 123_457, 5),
    "small": (1_000, 3, 1_000, False, 2_000, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(START_CASES))
def test_pool_start_kernel_equals_the_torch_fill(cuda, case):
    """start_kernel writes the state rows and the counters (next_work, the
    live count, segments, steps) that the plain fill makes with torch ops
    on the card, bit for bit, in one launch."""
    n, spp, p, spec, poff, soff = START_CASES[case]
    cam = tcam.make_camera(image_width=800, image_height=450,
                           defocus_angle=0.6, **CAM_KW).to(cuda)
    env = tenv.make_environment(**ENV_KW).to(cuda)
    n_beauty = n * spp
    sp = fs.StepParams(
        seed=rng.seed_from_int(2**31 + 17), sample_offset=soff, n_pixels=n,
        width=800, total_work=n_beauty * (2 if spec else 1), max_depth=10,
        env_mode=tenv.PHYSICAL_SUN, use_reflection=spec, use_refraction=spec,
        n_beauty=n_beauty, pixel_offset=poff)
    launches = fs.initial_state.launches
    got = fs.initial_state(cam, fs._bparams(cam, env, cuda), sp, p)
    assert fs.initial_state.launches == launches + 1
    want = fs.initial_state_plain(cam, sp, p, cuda)
    assert got[0].shape == (15 if spec else 12, p)
    if spec:
        assert 0 < int(want[1][4].sum()) < p
    agree.same_bits(got, want)


@pytest.mark.cuda
def test_pool_setup_on_a_hit_reads_nothing_back(cuda):
    """A second pool call over the same scene, environment and camera
    reuses the tables and both parameter vectors: its `pool.setup` holds no
    `tables.build`, no read-back or copy, and at most ten torch ops, where
    the first call's build reads back."""
    from torch.profiler import ProfilerActivity, profile

    scene, cam, env, cfg = _window_frame(cuda, 64, 36, 2)
    cam, env = cam.to(cuda), env.to(cuda)
    caches = (fs.tables_cache, fs.params_cache)
    setups = []
    for seed in (0, 1):
        built = [c.built for c in caches]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fs.render_pool_fused(scene, cam, env, seed, cfg, 1)
        setup, = [e for e in prof.events() if e.name == "pool.setup"]
        setups.append(_subtree(setup))
        assert [c.built - b for c, b in zip(caches, built)] == [1 - seed] * 2
    reads = ("aten::_local_scalar_dense", "aten::item", "aten::copy_",
             "aten::_to_copy")
    assert [e for e in setups[0] if e.name in reads]
    assert "tables.build" in [e.name for e in setups[0]]
    hit = setups[1]
    assert not [e.name for e in hit if e.name in reads or e.name.startswith(
        "tables.")]
    assert len([e for e in hit if e.name.startswith("aten::")
                and not (e.cpu_parent or e).name.startswith("aten::")]) <= 10


def _subtree(event) -> list:
    out = []
    for child in event.cpu_children:
        out += [child, *_subtree(child)]
    return out


# --- the fused pool's closest hit over the BVH (csrc/bvh_hit.cu) -----------

def _bvh_funnel_rays(cuda, n=131_072, n_spheres=8192, mesh_detail=2,
                     step=1):
    """The funnel (25,090 primitives; or n_spheres and mesh_detail tori)
    with its pool tables (BVH attached) on the card, and n bounce lanes:
    one scatter of the 800x450 funnel camera's rays (every step-th pixel)
    at their first hits, and what each lane left (index, type, hit)."""
    from raytracer_project_tpu_torch.ops import shade

    scene = presets.bvh_stress_scene(n_spheres=n_spheres,
                                     mesh_detail=mesh_detail,
                                     with_bvh=False).to(cuda)
    scan = fs.build_tables(scene, tenv.make_environment(**ENV_KW).to(cuda),
                           tenv.PHYSICAL_SUN).scan
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **FUNNEL_CAM).to(cuda)
    pix = torch.arange(800 * 450, device=cuda)[::step][:n]
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    od = torch.cat([sc.origin.T, sc.direction.T]).contiguous()
    return scene, scan, od, (first.prim_idx, first.prim_type, first.hit)


def _against_k1(tb, ib, yb, tk, ik, yk):
    """The BVH kernel against K1's tile scan (`agree.against_k1`); returns
    (hits, hit flips, winner flips)."""
    out = agree.against_k1((tb, ib, yb), (tk, ik, yk))
    return out["hits"], out["hit_flips"], out["winner_flips"]


@pytest.mark.cuda
def test_bvh_kernel_matches_k1_on_funnel_bounce_rays(cuda):
    """On the funnel's 131,072 bounce lanes the BVH kernel finds K1's hits:
    t bit for bit where both chose the same primitive, hit and winner flips
    within stage_hit_agree's budgets; and it is counted as K1's launch."""
    scene, scan, od, _ = _bvh_funnel_rays(cuda)
    assert scan.bvh is not None and scan.bvh.nodes.is_cuda
    launches, bvh_launches = k1.closest_hit.launches, k1.closest_hit.bvh_launches
    tb, ib, yb = k1.closest_hit(od, 1e-3, scan)
    assert (k1.closest_hit.launches - launches,
            k1.closest_hit.bvh_launches - bvh_launches) == (1, 1)
    tk, ik, yk = k1.closest_hit(od, 1e-3, scan._replace(bvh=None))
    n = od.shape[1]
    hits, flips, winner = _against_k1(tb, ib, yb, tk, ik, yk)
    print(f"funnel bounce lanes {n}: hits {hits}, hit flips {flips}, "
          f"winner flips {winner}")
    assert hits > n // 10


@pytest.mark.cuda
def test_bvh_kernel_matches_k1_on_the_showcase(cuda, monkeypatch):
    """The showcase's tables with the threshold lowered under its primitive
    count: the BVH kernel against K1's tile scan on camera-like and
    bounce-like rays, as on the funnel."""
    scene = presets.showcase_scene(with_bvh=False).to(cuda)
    monkeypatch.setattr(intersect, "BVH_MIN_PRIMS", scene.primitive_count)
    scan = fs.build_tables(scene, tenv.make_environment(**ENV_KW).to(cuda),
                           tenv.PHYSICAL_SUN).scan
    assert scan.bvh is not None
    r = np.random.default_rng(5)
    o = np.stack([r.uniform(-10, 10, P), r.uniform(0.05, 4, P),
                  r.uniform(-10, 10, P)], 1)
    d = r.normal(size=(P, 3))
    od = torch.as_tensor(np.concatenate([o.T, d.T]).astype(np.float32)).to(
        cuda).contiguous()
    tb, ib, yb = k1.closest_hit(od, 1e-3, scan)
    tk, ik, yk = k1.closest_hit(od, 1e-3, scan._replace(bvh=None))
    hits, flips, winner = _against_k1(tb, ib, yb, tk, ik, yk)
    print(f"showcase lanes {P}: hits {hits}, hit flips {flips}, "
          f"winner flips {winner}")
    assert hits > P // 4


def _against_plain(scene, od, tb, ib, yb, tp, ip, yp, near):
    """The BVH kernel against its plain traversal under the reference's
    budgets: hit flips <= 1%, winner flips <= 2.5%, same-winner t over
    5e-3 relative on at most 3%, none over 5e-2 but on the lanes `near`
    or those met so nearly tangentially that f32 cannot resolve t
    (`agree.grazing`)."""
    assert int((tb < 1e30).sum()) > od.shape[1] // 10
    near = (near | (torch.minimum(tb, tp) < agree.NEAR_ORIGIN)
            | agree.grazing(scene, od[:3].T, od[3:].T, tb, ib, yb))
    agree.hit_budgets((tb, ib, yb), (tp, ip, yp), near)


@pytest.mark.cuda
def test_bvh_kernel_matches_its_plain_traversal(cuda):
    """The kernel against its plain version (the threaded traversal of
    ops/traverse.py, on the card) on the funnel's bounce lanes, under the
    reference's budgets; a lane that hits the primitive it left, within
    0.02 of its origin (the funnel's spheres overlap), or so nearly
    tangentially that f32 cannot resolve t (`agree.grazing`), counts in the 3%
    budget but not under the 5e-2 cap: each formulation's rounding decides
    such a root."""
    scene, scan, od, left = _bvh_funnel_rays(cuda, n=65_536)
    tb, ib, yb = k1.bvh_closest_hit(od, 1e-3, scan)
    tp, ip, yp = k1.bvh_closest_hit_plain(od, 1e-3, scan.bvh)
    _against_plain(scene, od, tb, ib, yb, tp, ip, yp,
                   left[2] & (ib == left[0]) & (yb == left[1]))


@pytest.mark.cuda
def test_bvh_kernel_on_bench_bvhs_largest_scene(cuda):
    """tools/bench_bvh.py's largest case, the funnel of 65,536 spheres and
    six tori (116,227 primitives, a deeper tree than the pool's funnel), on
    8,192 bounce lanes spread over the 800x450 frame: the kernel against
    its plain traversal under the reference's budgets (`_against_plain`),
    and against K1's tile scan, t bit for bit where both chose the same
    primitive."""
    scene, scan, od, left = _bvh_funnel_rays(
        cuda, n=8192, n_spheres=65536, mesh_detail=6, step=800 * 450 // 8192)
    assert scene.primitive_count == 116_227 and od.shape[1] == 8192
    tb, ib, yb = k1.closest_hit(od, 1e-3, scan)
    tp, ip, yp = k1.bvh_closest_hit_plain(od, 1e-3, scan.bvh)
    _against_plain(scene, od, tb, ib, yb, tp, ip, yp,
                   left[2] & (ib == left[0]) & (yb == left[1]))
    tk, ik, yk = k1.closest_hit(od, 1e-3, scan._replace(bvh=None))
    hits, flips, winner = _against_k1(tb, ib, yb, tk, ik, yk)
    print(f"116,227 primitives, depth {scan.bvh.depth}, {scan.bvh.node_count} "
          f"nodes, lanes {od.shape[1]}: hits {hits}, hit flips {flips}, "
          f"winner flips {winner}")


@pytest.mark.cuda
def test_bvh_walks_count_and_answer_as_the_pools(cuda):
    """On 16,384 of the funnel's bounce lanes the counting walk returns the
    pool's answer bit for bit, and its launch is not counted; the counts
    are the walk's own: every ray visits the root's record and fewer
    records than the tree holds, no ray culls more pops than it pushed, the
    walk pushes and culls, and a ray tests at most two leaves a visit. The
    tree is the card's (leaves of up to HIT_LEAF_SIZE), also for a scene
    built with its own leaf-16 tree."""
    from raytracer_project_tpu_torch.ops import bvh as tbvh

    _, scan, od, _ = _bvh_funnel_rays(cuda, n=16_384)
    leaf = scan.bvh.tree.leaf_size
    assert leaf <= tbvh.HIT_LEAF_SIZE
    pool = k1.bvh_closest_hit(od, 1e-3, scan)
    launches = k1.closest_hit.launches
    *counted, c = k1.bvh_walk_counted(od, 1e-3, scan)
    assert k1.closest_hit.launches == launches
    for a, b in zip(pool, counted):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert c.shape == (4, od.shape[1])
    assert bool((c[0] >= 1).all())
    assert bool((c[0] < scan.bvh.nodes.shape[0]).all())
    assert bool((c[2] <= c[1]).all())
    assert int(c[1].sum()) > 0 and int(c[2].sum()) > 0
    assert bool((c[3] <= 2 * leaf * c[0]).all())
    print(f"per ray: {c.double().mean(1).tolist()}")

    own = presets.bvh_stress_scene(n_spheres=512, mesh_detail=1).to(cuda)
    assert own.bvh.leaf_size > tbvh.HIT_LEAF_SIZE
    assert tbvh.hit_bvh(own).tree.leaf_size <= tbvh.HIT_LEAF_SIZE


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 1])
def test_bvh_kernel_on_no_lane_and_one(cuda, lanes):
    """No lane launches nothing and returns empty outputs; one lane gets
    K1's answer."""
    scene, scan, od, _ = _bvh_funnel_rays(cuda, n=64)
    od = od[:, :lanes].contiguous()
    tb, ib, yb = k1.closest_hit(od, 1e-3, scan)
    torch.cuda.synchronize()
    assert tb.shape == ib.shape == yb.shape == (lanes,)
    tk, ik, yk = k1.closest_hit(od, 1e-3, scan._replace(bvh=None))
    assert torch.equal(tb, tk) and torch.equal(ib, ik) and torch.equal(yb, yk)


@pytest.mark.cuda
def test_fused_pool_renders_the_funnel_through_the_bvh_kernel(cuda,
                                                             monkeypatch):
    """integrator.render of the funnel (64x36 @ 2 spp) on the card: every
    closest hit of the pool is a BVH launch, the tree is built once, and
    the frame matches the same frame on K1's tile scan (a frame whose pool
    was handed tables without the tree) within the pool budgets."""
    scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2,
                                     with_bvh=False)
    cam = tcam.make_camera(image_width=64, image_height=36, **FUNNEL_CAM)
    env = tenv.make_environment(**ENV_KW)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=2,
                                  max_depth=10)
    from raytracer_project_tpu_torch.ops import bvh as tbvh

    builds = tbvh.hit_bvh.builds
    launches, bvh_launches = k1.closest_hit.launches, k1.closest_hit.bvh_launches
    out = integrator.render(scene, cam, env, 1, cfg, device=cuda)["beauty"]
    n = k1.closest_hit.launches - launches
    assert n > 0 and k1.closest_hit.bvh_launches - bvh_launches == n
    assert tbvh.hit_bvh.builds == builds + 1
    orig = fs.build_tables

    def without_tree(*args):
        t = orig(*args)
        return t._replace(scan=t.scan._replace(bvh=None))

    monkeypatch.setattr(fs, "build_tables", without_tree)
    monkeypatch.setattr(fs, "tables_cache", fs.DerivedCache())
    bvh_launches = k1.closest_hit.bvh_launches
    ref = integrator.render(scene, cam, env, 1, cfg, device=cuda)["beauty"]
    assert k1.closest_hit.bvh_launches == bvh_launches
    a, b = out.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(a).all() and a.max() > 0
    dd = np.abs(a - b)
    assert dd.mean() <= 0.01 and (dd.max(axis=-1) > 0.05).mean() <= 0.01


@pytest.mark.cuda
def test_closest_hit_feats_on_funnel_bounce_rays(cuda):
    """K4 on the funnel's 360,000 bounce lanes (one scatter of the 800x450
    funnel camera's rays) against its plain version and the brute-force
    oracle, and K1 on the first 131,072 (the pool's width) against K4,
    under `_against_plain`'s budgets: lanes that hit the primitive they
    left, within 0.02 of their origin or grazing count in the 3% budget,
    not under the 5e-2 cap."""
    scene, _, od, left = _bvh_funnel_rays(cuda, n=800 * 450)
    tables = k1.scan_tables(scene)
    o, d = od[:3].T.contiguous(), od[3:].T.contiguous()
    feats = intersect.ray_feature_rows(o, d).contiguous()
    tk, ik, yk = k1.closest_hit_feats(feats, 1e-3, tables)
    near = left[2] & (ik == left[0]) & (yk == left[1])
    _against_plain(scene, od, tk, ik, yk, *k1.closest_hit_feats_plain(
        feats, 1e-3, tables.coeffs, tables.counts), near)
    ob = intersect.intersect_brute(scene, o, d, 1e-3)
    _against_plain(scene, od, tk, ik, yk, ob.t, ob.prim_idx, ob.prim_type,
                   near)
    n = 131_072
    t1, i1, y1 = k1.closest_hit(od[:, :n].contiguous(), 1e-3, tables)
    _against_plain(scene, od[:, :n], t1, i1, y1, tk[:n], ik[:n], yk[:n],
                   left[2][:n] & (i1 == left[0][:n]) & (y1 == left[1][:n]))


@pytest.mark.cuda
def test_bvh_walk_at_every_leaf_size_answers_as_k1(cuda):
    """tools/bench_bvh's walk sweep on the funnel's 131,072 bounce lanes:
    the BVH kernel over trees of each leaf size finds K1's hits, t bit for
    bit where both chose the same primitive, hit and winner flips within
    the reference's budgets."""
    from raytracer_project_tpu_torch.tools import bench_bvh

    scene, scan, od, _ = _bvh_funnel_rays(cuda)
    n = od.shape[1]
    rows = bench_bvh.walk_sweep(scene, od, scan)
    assert [row["leaf_size"] for row in rows] == list(bench_bvh.LEAF_SIZES)
    for row in rows:
        diff = row["vs_k1"]
        assert (diff["t_bits_differ"] == 0
                and diff["hit_flips"] <= max(2, n // 100)
                and diff["winner_flips"] <= max(2, n // 40)), row


@pytest.mark.cuda
def test_bench_bvh_cases_agree_on_card(cuda):
    """tools/bench_bvh.py's seven cases (810 to 116,227 primitives) on
    262,144 mixed rays each: the BVH traversal and K4 agree on a hit and
    its t (within 1e-3) on at least 96.5% of the rays; the fused pool's BVH
    kernel finds K1's hits, t bit for bit where both chose the same
    primitive, hit and winner flips within the reference's budgets, at
    every leaf size of its walk sweep too."""
    from raytracer_project_tpu_torch.tools import bench_bvh

    rows = bench_bvh.main("cuda")
    assert len(rows) == len(bench_bvh.CASES)
    for row in rows:
        n = row["rays"]
        assert n == bench_bvh.N_RAYS
        assert row["hit_agreement"] >= 0.965, row["scene"]
        for diff in [row["k1_vs_bvh_kernel"]] + [w["vs_k1"]
                                                for w in row["walks"]]:
            assert (diff["t_bits_differ"] == 0
                    and diff["hit_flips"] <= max(2, n // 100)
                    and diff["winner_flips"] <= max(2, n // 40)), (
                        row["scene"], diff)


# --- the fused pool's captured steps (ops/step_graphs.py) --------------------

def _cornell_smoke():
    """(scene, camera keywords, environment keywords, depth) of the
    benchmark's fog Cornell box (`benchmark/configs/cornell_smoke.*`): six
    boxes, an emitter, two box media of density 0.01, a black world."""
    from benchmark import harness
    from raytracer_project_tpu_torch.models.scene import SceneBuilder

    cell = harness.load_cell("cornell_smoke.final")
    cfg = cell.cfg
    b = SceneBuilder()
    cell.generator.build(b, cfg)
    cam_kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["camera"].items()}
    env_kw = {k: v for k, v in cfg["environment"].items() if k != "mode"}
    return (b.build(with_bvh=False), cam_kw, env_kw,
            int(cfg["render"]["max_depth"]))


def _graph_frame(cuda, name, w=64, h=36, spp=2, **cfg_kw):
    """(scene, camera, environment, config) of a frame of the showcase or
    of the funnel (its BVH built by the pool), beauty, depth 10, or of the
    fog Cornell box (a black world, depth 50), inputs on the card."""
    env_kw = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
    depth, mode = 10, tenv.PHYSICAL_SUN
    if name == "funnel":
        scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2,
                                         with_bvh=False)
        cam_kw = FUNNEL_CAM
    elif name == "cornell":
        scene, cam_kw, env_kw, depth = _cornell_smoke()
        mode = tenv.SOLID_COLOR
    else:
        scene, cam_kw = presets.showcase_scene(), CAM_KW
    cam = tcam.make_camera(image_width=w, image_height=h, **cam_kw)
    env = tenv.make_environment(**env_kw)
    cfg = integrator.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                                  max_depth=depth, env_mode=mode,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False, **cfg_kw)
    return scene.to(cuda), cam.to(cuda), env.to(cuda), cfg


def _graph_counts():
    """K1 launches, BVH launches, K3 fused launches, captures (a pair of
    graphs each), replays."""
    k3 = fs.shade_accumulate
    return (k1.closest_hit.launches, k1.closest_hit.bvh_launches,
            k3.launches + k3.features_launches, step_graphs.cache.captured,
            step_graphs.cache.replayed)


def _pool_call(inputs, seed):
    """One pool call: (beauty on the host, stats, _graph_counts' growth)."""
    before = _graph_counts()
    out, st = fs.render_pool_fused(*inputs[:3], seed, inputs[3], 0,
                                   with_stats=True)
    beauty = out.beauty.cpu()
    return beauty, st, tuple(a - b for a, b in zip(_graph_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["showcase", "funnel", "cornell"])
@pytest.mark.parametrize("size", [(64, 36, 2), (800, 450, 32)])
def test_replayed_steps_equal_the_eager_steps(cuda, name, size, monkeypatch):
    """A pool call stepped launch by launch (the entry's `take` stood in
    for), then the same call twice on the captured step: the first
    captures two graphs and replays them, a replay a turn, the second only
    replays. Each has the eager call's segments and steps, its beauty
    within rtol/atol 3e-4 (K3 fused adds in no fixed order) and its
    launches (K1, on the funnel the BVH kernel every time, and K3 fused as
    often: one more than the steps, the lag's no-op step), the capture
    adding none. At 800x450 @ 32 spp, chip_smoke.py's frame (one pool
    call), these are the launches a frame. In the fog Cornell box the
    stats' scatters (K3 fused's fog variant) are the eager call's too, and
    not 0."""
    monkeypatch.setattr(step_graphs, "cache", step_graphs.StepGraphs())
    inputs = _graph_frame(cuda, name, *size)
    with monkeypatch.context() as eager:
        eager.setattr(step_graphs.cache, "take", lambda *a: None)
        want, est, el = _pool_call(inputs, 3)
    assert el[3:] == (0, 0) and est["steps"] > 0
    for captured in (1, 0):
        graph, gst, gl = _pool_call(inputs, 3)
        print(name, size, "launches a call", el[:3], gl[:3], est)
        assert gl[3:] == (captured, gl[0])
        assert gst == est
        assert gl[:3] == el[:3] and gl[0] == gl[2] == gst["steps"] + 1
        assert gl[1] == (gl[0] if name == "funnel" else 0)
        assert (gst["scatters"] > 0) == (name == "cornell")
        torch.testing.assert_close(graph, want, rtol=3e-4, atol=3e-4)
        assert float(graph.max()) > 0


@pytest.mark.cuda
def test_fog_kernel_counts_the_plain_scatters_in_the_cornell_box(cuda):
    """K3 fused's beauty fog variant (`shade_kernel<false, false, true,
    true>`) against its plain version on one step of P random path states
    inside the fog Cornell box (85% live, bounces 0-49): the counts of
    live segments that end in a medium differ by no more than the lanes
    whose fog flight may flip on an ulp of logf (0.5% of the pool, the
    budget of the features step), and there are thousands of them; the
    rest of the step as agree.fused_step holds it."""
    scene, cam, env, cfg = _graph_frame(cuda, "cornell", 600, 600, 8)
    tables = fs.build_tables(scene, env, cfg.env_mode)
    r = np.random.default_rng(17)
    n = cfg.n_pixels
    od = torch.as_tensor(np.concatenate(
        [r.uniform(10.0, 545.0, (3, P)), r.normal(size=(3, P))]
    ).astype(np.float32)).to(cuda)
    state_f = torch.cat([od, torch.as_tensor(r.uniform(
        0.2, 1.5, (6, P)).astype(np.float32)).to(cuda)]).contiguous()
    state_i = torch.as_tensor(np.stack(
        [r.random(P) < 0.85, r.integers(0, 50, P), r.integers(0, 8, P),
         r.permutation(n)[:P]]).astype(np.int32)).to(cuda)
    sp = fs.StepParams(
        seed=rng.seed_from_int(7), sample_offset=0, n_pixels=n, width=600,
        total_work=n * 8, max_depth=50, env_mode=cfg.env_mode, aux=0,
        z_max=50.0, aovs=(), use_reflection=False, use_refraction=False,
        n_beauty=n * 8, n_volumes=scene.volumes.count)
    hits = k1.closest_hit(od, 1e-3, tables.scan)
    aparams, bparams = fs._aparams(env, cuda), fs._bparams(cam, env, cuda)
    state = (state_f, state_i,
             torch.tensor([n * 8 - 9000], dtype=torch.int32, device=cuda),
             torch.tensor([11], dtype=torch.int64, device=cuda))
    budget = int(0.005 * P)
    agree.fused_step(tables, hits, state, aparams, bparams, sp, budget,
                     "cornell")
    counts = []
    for fn in (fs.shade_accumulate, fs.shade_accumulate_plain):
        scatters = torch.zeros(1, dtype=torch.int64, device=cuda)
        fn(tables, hits, *state[:4], torch.zeros(1, dtype=torch.int64,
                                                 device=cuda),
           aparams, bparams, sp, fs.new_accumulator(sp, cuda), scatters)
        counts.append(int(scatters))
    print("cornell scatters card, plain:", counts)
    assert abs(counts[0] - counts[1]) <= budget
    assert counts[1] > 1000


@pytest.mark.cuda
def test_step_graphs_captured_once_per_key(cuda, monkeypatch):
    """Sessions of the showcase at 64x36, 4 spp in updates of 2, over two
    camera poses and three keys: the first update captures two graphs,
    and it and every later update and frame replay them, `replayed`
    growing by the turns taken (a K1 launch each); a new pool size, a new
    variant (the albedo AOV) and new tables (another scene) each capture
    again."""
    from raytracer_project_tpu_torch.utils.session import RenderSession

    monkeypatch.setattr(step_graphs, "cache", step_graphs.StepGraphs())
    graphs = step_graphs.cache
    scene, cam, env, cfg = _graph_frame(cuda, "showcase", spp=4)
    cam2 = tcam.make_camera(image_width=64, image_height=36, vfov=40.0,
                            lookfrom=(-9.0, 3.0, 7.0),
                            lookat=(0.0, 0.5, 0.0)).to(cuda)

    def session(camera, key, config=cfg, world=scene):
        sess = RenderSession(world, camera, env, config, key=key,
                             chunk_samples=2, device=cuda)
        sess.step(2)
        sess.step(2)
        assert float(sess.buffers()["beauty"].max()) > 0

    launches = k1.closest_hit.launches
    session(cam, 0)
    assert graphs.captured == 1
    assert graphs.replayed == k1.closest_hit.launches - launches > 0
    replayed, launches = graphs.replayed, k1.closest_hit.launches
    session(cam2, 1)
    session(cam, 2)
    assert graphs.captured == 1
    assert graphs.replayed - replayed == k1.closest_hit.launches - launches > 0
    for config, world in ((dataclasses.replace(cfg, pool_lanes=4096), scene),
                          (dataclasses.replace(cfg, use_albedo=True), scene),
                          (cfg, presets.showcase_scene(seed=5).to(cuda))):
        captured = graphs.captured
        session(cam, 3, config, world)
        assert graphs.captured == captured + 1


@pytest.mark.cuda
def test_a_held_entry_gets_a_second_one(cuda, monkeypatch):
    """While one call holds its key's captured step, another call of the
    same key on the same stream captures an entry of its own and renders
    what the first entry renders; once the first is free again, calls
    take an entry without capturing."""
    monkeypatch.setattr(step_graphs, "cache", step_graphs.StepGraphs())
    inputs = _graph_frame(cuda, "showcase")
    want, _, gl = _pool_call(inputs, 5)
    assert gl[3] == 1
    tables, _, _, sp, p = fs._pool_setup(*inputs[:3], 5, inputs[3], 0)
    held = step_graphs.cache.take(tables, sp, p)
    try:
        assert step_graphs.cache.captured == 1
        got, _, gl = _pool_call(inputs, 5)
        assert gl[3] == 1
    finally:
        held.lock.release()
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    for _ in range(2):
        assert _pool_call(inputs, 5)[2][3] == 0
    assert step_graphs.cache.captured == 2


@pytest.mark.cuda
def test_window_threads_capture_on_their_streams(cuda, monkeypatch):
    """The smoke gate's fused-fast frame (64x36 @ 2 spp) over four windows
    of cuda:0, each in a thread of its own on a stream of its own
    (parallel/render.py), twice: in the first frame each window captures
    its step on its stream and replays it, in the second each only
    replays it there; both frames hold the one-card frame's device
    golden."""
    from raytracer_project_tpu_torch.parallel import render as prender
    from raytracer_project_tpu_torch.utils import smoke

    monkeypatch.setattr(step_graphs, "cache", step_graphs.StepGraphs())
    graphs = step_graphs.cache
    scene, cam, env = smoke._showcase(64, 36)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=2,
                                  max_depth=10, env_mode=tenv.PHYSICAL_SUN,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False)
    info = smoke.device_info(cuda)
    inputs = (scene.to(cuda), cam.to(cuda), env.to(cuda))
    for _ in range(2):
        replayed = graphs.replayed
        img = prender.render_sharded(*inputs, 0, cfg,
                                     [torch.device("cuda", 0)] * 4)
        img = img["beauty"].cpu().numpy()
        assert graphs.captured == 4
        assert graphs.replayed > replayed
        assert smoke._check_image(img, "smoke_fused_64x36", "windows", 0.01,
                                  device=info) is None
    assert len(graphs._entries) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["showcase", "funnel", "cornell"])
def test_replayed_steps_show_their_kernels_to_the_profiler(cuda, name,
                                                           monkeypatch):
    """Under torch.profiler, as the benchmark's traced runs read it
    (kineto's device events), a pool call that replays its captured step
    shows the kernels the roofline readers look for, each with device
    time: K1's tile scan (on the funnel the BVH walk), K3 fused's shade
    kernel (in the fog Cornell box its fog variant, under the name that
    `benchmark/layer_metrics/k3.fog_roofline_share.py` matches) and the
    respawn kernel."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(step_graphs, "cache", step_graphs.StepGraphs())
    inputs = _graph_frame(cuda, name, 200, 113, 4)
    _pool_call(inputs, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, gl = _pool_call(inputs, 1)
        torch.cuda.synchronize()
    assert gl[3] == 0 and gl[4] > 0
    dev_ns = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            dev_ns[e.name()] = (dev_ns.get(e.name(), 0)
                                + int(e.end_ns()) - int(e.start_ns()))
    hit = "bvh_hit_kernel" if name == "funnel" else "tile_scan_kernel<true"
    shade = ("shade_kernel<false, false, true, true>" if name == "cornell"
             else "shade_kernel<false, false, false, true>")
    print(name, sorted(dev_ns))
    for tag in (hit, shade, "respawn_kernel"):
        assert sum(v for k, v in dev_ns.items() if tag in k) > 0, (
            tag, sorted(dev_ns))


# --- the smoke gate's renders, the published configurations -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("render", ["render_fused_fast",
                                    "render_fused_features", "render_pool"])
def test_smoke_renders_repeat_within_the_golden_interlock(cuda, render):
    """Each smoke stage's images (utils/smoke.py) have a device golden made
    on this card and CUDA version, so the gate holds each to it; and three
    renders differ by a mean |d| within make_device_goldens' interlock
    (SPREAD_MEAN), though K3 fused adds in no fixed order."""
    from raytracer_project_tpu_torch.tools import make_device_goldens as mdg
    from raytracer_project_tpu_torch.utils import smoke

    info = smoke.device_info(cuda)
    runs = [getattr(smoke, render)(cuda) for _ in range(3)]
    for k, (name, _, _, _) in enumerate(runs[0]):
        with np.load(smoke._golden_path(name + smoke.DEVICE_SUFFIX)) as g:
            assert (str(g["device"]), str(g["cuda"])) == (info.name,
                                                          info.cuda), name
        mean, _ = mdg.spread([r[k][3] for r in runs])
        assert mean <= mdg.SPREAD_MEAN, (name, mean)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "differentiable"])
def test_showcase_golden_on_card(cuda, mode, monkeypatch):
    """The chunked showcase frame of tests/goldens/showcase.npz (64x36 @ 8
    spp, depth 6) on the card, plain and differentiable (K4 on detached
    rays): K4 launched, no plain version run, and the image within the
    cross-backend budgets (0.06 / 0.20) of the golden. The differentiable
    frame also holds the CPU's differentiable render (mean |d| < 1e-3, less
    than 0.5% of values over 3e-3) and the card's plain render (mean |d| <
    1e-3: the reference's own differentiable render leaves 0.535% of
    values over 3e-3 against its plain render here)."""
    from raytracer_project_tpu_torch import diff

    scene, cam, env, cfg = goldens.golden_config("showcase")
    differentiable = mode == "differentiable"
    cfg = dataclasses.replace(cfg, differentiable=differentiable)
    cpu = None
    if differentiable:
        with torch.no_grad():
            cpu = diff.render_beauty(diff.RenderState(scene, cam, env), 0,
                                     cfg, device="cpu").numpy()
    plain_calls = _plain_calls(monkeypatch)
    k1.closest_hit_feats.launches = 0
    card = scene.to(cuda)
    if differentiable:
        img = diff.render_beauty(diff.RenderState(card, cam, env), 0, cfg,
                                 device=cuda).detach().cpu().numpy()
    else:
        img = integrator.render(card, cam, env, 0, cfg)["beauty"].cpu().numpy()
    assert k1.closest_hit_feats.launches > 0 and not plain_calls
    mean, frac = goldens.golden_diff(img, "showcase")
    assert np.isfinite(img).all() and mean <= 0.06 and frac <= 0.20
    if differentiable:
        d = np.abs(img - cpu)
        assert d.mean() < 1e-3 and (d > 3e-3).mean() < 0.005
        ref = integrator.render(card, cam, env, 0, dataclasses.replace(
            cfg, differentiable=False))["beauty"].cpu().numpy()
        assert np.abs(img - ref).mean() < 1e-3


def _baseline_config(name):
    """(scene, camera, environment, config) of the repository's render
    configurations at their published sizes (BASELINE.json configs 1, 2
    and 4) and the benchmark's funnel, beauty only."""
    from raytracer_project_tpu_torch.bench import FUNNEL_CAM

    beauty = dict(use_albedo=False, use_normal=False, use_z_depth=False)
    shirley_cam = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
                       lookat=(0.0, 0.0, 0.0), focus_dist=10.0)
    if name == "config1":
        return (presets.shirley_final_scene(grid=11),
                dict(shirley_cam, defocus_angle=0.6),
                tenv.make_environment(background_color=(0.7, 0.8, 1.0)),
                integrator.RenderConfig(width=400, height=225,
                                        samples_per_pixel=16, max_depth=8,
                                        env_mode=tenv.SOLID_COLOR, **beauty))
    if name == "config2":
        return (presets.cornell_box_scene(with_fog=True, fog_density=0.002),
                dict(vfov=40.0, lookfrom=(278.0, 278.0, -800.0),
                     lookat=(278.0, 278.0, 0.0)),
                tenv.make_environment(background_color=(0.0, 0.0, 0.0)),
                integrator.RenderConfig(width=512, height=512,
                                        samples_per_pixel=64, max_depth=8,
                                        env_mode=tenv.SOLID_COLOR, **beauty))
    if name == "config4":
        return (presets.shirley_final_scene(grid=11),
                dict(shirley_cam, defocus_angle=2.0),
                tenv.make_environment(hdr_image=goldens.procedural_hdr(),
                                      hdri_rotation=0.7, hdri_tilt=0.2,
                                      hdri_roll=0.1),
                integrator.RenderConfig(width=1920, height=1080,
                                        samples_per_pixel=8, max_depth=6,
                                        env_mode=tenv.HDR_MAP, **beauty))
    return (presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2),
            FUNNEL_CAM, tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                              sun_intensity=6.0),
            integrator.RenderConfig(width=800, height=450,
                                    samples_per_pixel=32, max_depth=10,
                                    **beauty))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config1", "config2", "config4", "funnel"])
def test_baseline_config_renders_through_its_kernels(cuda, name):
    """Each published configuration at its size on the fused pool, twice:
    its closest hit (the BVH kernel from BVH_MIN_PRIMS primitives on and the
    tile scan never there, else the tile scan alone) and K3 fused launched,
    the image finite and not black; past BVH_MIN_PRIMS the pool's tables,
    with their tree, built once over both renders."""
    scene, cam_kw, env, cfg = _baseline_config(name)
    scene = scene.to(cuda)
    cam = tcam.make_camera(image_width=cfg.width, image_height=cfg.height,
                           **cam_kw)
    built = fs.tables_cache.built
    integrator.render(scene, cam, env, 0, cfg)["beauty"].cpu()
    k1.closest_hit.launches = k1.closest_hit.bvh_launches = 0
    fs.shade_accumulate.launches = fs.shade_accumulate.features_launches = 0
    img = integrator.render(scene, cam, env, 1, cfg)["beauty"].cpu().numpy()
    launches, on_bvh = k1.closest_hit.launches, k1.closest_hit.bvh_launches
    assert launches > 0
    if scene.primitive_count >= intersect.BVH_MIN_PRIMS:
        assert on_bvh == launches
        assert fs.tables_cache.built - built == 1
    else:
        assert on_bvh == 0
    assert fs.shade_accumulate.launches + fs.shade_accumulate.features_launches > 0
    assert np.isfinite(img).all() and img.max() > 0


# --- the unfused pool, pixel windows and processes -------------------------

def _textured_fog_showcase(width, height):
    """The fog showcase with its fog's phase material textured by the
    scene's checker (outside the fused step: the unfused pool renders it)."""
    from raytracer_project_tpu_torch.models import textures

    scene = presets.showcase_scene(use_fog=True, fog_density=0.03)
    vmat = int(scene.volumes.mat[0])
    checker = int(torch.nonzero(scene.textures.kind
                                == textures.KIND_CHECKER)[0, 0])
    tex = torch.as_tensor(scene.materials.texture_id).clone()
    tex[vmat] = checker
    scene = scene._replace(
        materials=scene.materials._replace(texture_id=tex),
        volumes=scene.volumes._replace(textured=torch.tensor([vmat])))
    return (scene,
            tcam.make_camera(image_width=width, image_height=height,
                             **CAM_KW),
            tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                  sun_intensity=6.0))


@pytest.mark.cuda
def test_textured_fog_on_the_unfused_pool_matches_cpu(cuda, monkeypatch):
    """The fog showcase with textured fog at 64x36 @ 4 spp, beauty and
    albedo, takes the unfused pool on the card (K1 launched, no plain
    version run) and holds the port's CPU render under the cross-backend
    budgets 0.06 / 0.20."""
    scene, cam, env = _textured_fog_showcase(64, 36)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=4,
                                  max_depth=10, use_albedo=True,
                                  use_normal=False, use_z_depth=False)
    cpu = integrator.render(scene, cam, env, 2, cfg, device="cpu")
    plain_calls = _plain_calls(monkeypatch)
    k1.closest_hit.launches = 0
    card, st = integrator.render(scene.to(cuda), cam, env, 2, cfg,
                                 with_stats=True)
    assert st["engine"] == "pool" and k1.closest_hit.launches > 0
    assert not plain_calls
    for name in ("beauty", "albedo"):
        d = np.abs(card[name].cpu().numpy() - cpu[name].numpy())
        assert np.isfinite(d).all(), name
        assert d.mean() <= 0.06 and (d.max(-1) > 0.05).mean() <= 0.20, name


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["showcase", "funnel"])
def test_unfused_pool_sort_lanes_keeps_the_segments(cuda, scene_name,
                                                    monkeypatch):
    """The unfused pool at the main path's size (800x450 @ 32 spp, beauty,
    depth 10, 262,144 lanes) on the showcase and the funnel, with the
    lanes re-sorted after every step and without: the same segments, K1
    launched and K3 fused not, the image finite and not black."""
    from raytracer_project_tpu_torch.bench import FUNNEL_CAM

    monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    if scene_name == "funnel":
        scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2)
        cam_kw = FUNNEL_CAM
    else:
        scene, cam_kw = presets.showcase_scene(), CAM_KW
    scene = scene.to(cuda)
    cam = tcam.make_camera(image_width=800, image_height=450, **cam_kw)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=800, height=450, samples_per_pixel=32,
                                  max_depth=10, use_albedo=False,
                                  use_normal=False, use_z_depth=False)
    segments = []
    for sort in (False, True):
        k1.closest_hit.launches = fs.shade_accumulate.launches = 0
        fs.shade_accumulate.features_launches = 0
        out, st = integrator.render(scene, cam, env, 1, dataclasses.replace(
            cfg, sort_lanes=sort), with_stats=True)
        img = out["beauty"].cpu().numpy()
        assert st["engine"] == "pool" and k1.closest_hit.launches > 0
        assert (fs.shade_accumulate.launches
                == fs.shade_accumulate.features_launches == 0)
        assert np.isfinite(img).all() and img.max() > 0
        segments.append(st["segments"])
    assert segments[0] == segments[1]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pool", "chunked"])
def test_explicit_pixel_ids_sum_as_one_call_on_card(cuda, engine,
                                                    monkeypatch):
    """Explicit pixel ids (every third pixel of a 200x113 frame, shuffled,
    7,000 of them) over 4 windows of cuda:0 on the unfused pool and the
    chunked path: the engine's kernel launched, the segments of one call
    with the same ids, and sums within rtol/atol 3e-4 of that call and of
    the whole frame's rows at those ids (the frame on the same engine)."""
    from raytracer_project_tpu_torch.parallel import render as prender

    scene, cam, env, cfg = _window_frame(cuda, 200, 113, 4)
    cfg = dataclasses.replace(cfg, max_depth=10, use_albedo=False,
                              use_normal=False, use_z_depth=False,
                              wavefront=engine == "pool")
    ids = np.random.default_rng(5).permutation(
        np.arange(0, cfg.n_pixels, 3))[:7000]
    monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    whole = integrator.accumulate_samples(scene, cam, env, 4, cfg,
                                          with_stats=True)[0]
    monkeypatch.delenv("RAYTRACER_TPU_NO_FUSED")
    counter = k1.closest_hit if engine == "pool" else k1.closest_hit_feats
    counter.launches = 0
    acc, st = prender.sharded_accumulate(
        scene, cam, env, 4, cfg, ids, 0, mesh=prender.make_mesh(4, "cuda:0"),
        with_stats=True)
    assert counter.launches > 0
    sel = torch.as_tensor(ids, device=cuda)
    one, ost = integrator.accumulate_samples(scene, cam, env, 4, cfg, sel,
                                             with_stats=True)
    assert st["segments"] == ost["segments"]
    for ref in (one, integrator.SampleBuffers(*(x[sel] for x in whole))):
        for name, a, b in zip(acc._fields, acc, ref):
            torch.testing.assert_close(a, b.to(a.device), rtol=3e-4,
                                       atol=3e-4, msg=name)


def _spawn(worker, args, nprocs: int, seconds: int = 300) -> None:
    """Run worker(rank, *args) in `nprocs` spawned processes; fail if one
    fails or they do not finish within `seconds`."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(worker, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    for _ in range(seconds):
        if ctx.join(timeout=1):
            return
    for p in ctx.processes:
        p.kill()
    pytest.fail(f"the ranks did not finish within {seconds} s")


def _gloo_rank(rank: int, world: int, init: str, out: str) -> None:
    """One gloo rank: its window of the 256x144 @ 8 spp showcase on cuda:0,
    gathered; rank 0 writes the frame's beauty."""
    from raytracer_project_tpu_torch.parallel import distributed

    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=init, backend="gloo")
    try:
        scene, cam, env, cfg = _window_frame(torch.device("cuda"), 256, 144)
        img = distributed.render_distributed(scene, cam, env, 6, cfg,
                                             device="cuda:0")
        if distributed.is_host0():
            np.save(out, img["beauty"])
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_one_process(cuda, tmp_path):
    """Two spawned ranks on a gloo group (NCCL refuses two ranks on one
    card) render their windows of the 256x144 @ 8 spp showcase on cuda:0:
    the gathered frame equals the one-process render within rtol/atol
    3e-4."""
    out = tmp_path / "beauty.npy"
    _spawn(_gloo_rank, (2, f"file://{tmp_path / 'init'}", str(out)), 2)
    scene, cam, env, cfg = _window_frame(cuda, 256, 144)
    one = integrator.render(scene, cam, env, 6, cfg)["beauty"].cpu().numpy()
    got = np.load(out)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=3e-4, atol=3e-4)


def _nccl_rank(rank: int, world: int, per_process: int, init: str,
               out: str) -> None:
    """One NCCL rank of per_process cards from LOCAL_RANK * per_process:
    its windows of the 800x450 @ 32 spp showcase; rank 0 writes the
    beauty."""
    import os

    from raytracer_project_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=init)
    try:
        assert torch.distributed.get_backend() == "nccl"
        scene, cam, env, cfg = _window_frame(torch.device("cuda"), 800, 450,
                                             32)
        img = distributed.render_distributed(scene, cam, env, 0, cfg,
                                             per_process=per_process)
        if distributed.is_host0():
            np.save(out, img["beauty"])
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_nccl_ranks_on_distinct_cards(cuda, tmp_path):
    """Spawned NCCL ranks, one a card and (with four cards or more) two
    cards each, render the 800x450 @ 32 spp showcase: the frame equals the
    one-device render within rtol/atol 3e-4. Needs two cards or more."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"NCCL ranks on distinct cards need two; this machine "
                    f"has {count}")
    scene, cam, env, cfg = _window_frame(cuda, 800, 450, 32)
    one = integrator.render(scene, cam, env, 0, cfg)["beauty"].cpu().numpy()
    for world, per_process in ((count, 1), (count // 2, 2)):
        if per_process == 2 and (count < 4 or count % 2):
            continue
        out = tmp_path / f"nccl_{world}x{per_process}.npy"
        _spawn(_nccl_rank, (world, per_process,
                            f"file://{tmp_path / f'init_{world}'}", str(out)),
               world)
        np.testing.assert_allclose(np.load(out), one, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_post_chain_and_png_writers_on_card(cuda, tmp_path):
    """The post chain (bloom, sharpening) on the showcase's beauty on the
    card against the CPU within 1e-5; the statistics of 4 windows of
    cuda:0 (analyze_sharded) equal the image's; the exported PNG written by
    save_png, the native writer and the pure-Python one reads back pixel
    for pixel."""
    from raytracer_project_tpu_torch import native
    from raytracer_project_tpu_torch.core import colorspace
    from raytracer_project_tpu_torch.ops import post
    from raytracer_project_tpu_torch.parallel import render as prender
    from raytracer_project_tpu_torch.utils import image_io

    scene, cam, env, cfg = _window_frame(cuda, 256, 144)
    beauty = integrator.render(scene, cam, env, 6, cfg)["beauty"]
    pcfg = post.PostConfig(use_bloom=True, use_sharpening=True)
    params = post.make_post_params(exposure=0.3)
    card = post.update_post_processing(beauty, params.to(cuda), pcfg)
    cpu = post.update_post_processing(beauty.cpu(), params, pcfg)
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5
    flat = beauty.reshape(-1, 3)
    whole = post.analyze_framebuffer(flat)
    parts = prender.analyze_sharded(flat, prender.make_mesh(4, "cuda:0"))
    assert torch.equal(whole.histogram, parts.histogram)
    assert float(whole.max_luminance) == float(parts.max_luminance)
    assert abs(float(whole.average_luminance)
               - float(parts.average_luminance)) <= 1e-5 * float(
                   whole.average_luminance)
    px = colorspace.to_srgb_u8(card).cpu().numpy()
    for writer, write in (("save_png", image_io.save_png),
                          ("native", native.write_png),
                          ("pure", image_io._save_png_pure)):
        path = str(tmp_path / f"post_{writer}.png")
        assert write(path, px) is not False, writer
        assert np.array_equal(image_io.read_png(path), px), writer


# --- the differentiable mode and the denoisers -----------------------------

def _free_render(state, cfg, paths, device, monkeypatch):
    """A differentiable render (seed 0) on `device` with every closest-hit
    search recorded: (image, {path: leaf}, the searches' Hits on the
    CPU)."""
    from raytracer_project_tpu_torch import diff

    state = state.to(device)
    params = {p: diff.tree_get(state, p).detach().clone().requires_grad_(True)
              for p in paths}
    search, hits = intersect.intersect, []

    def recorded(*args, **kw):
        hit = search(*args, **kw)
        hits.append(intersect.Hit(*(x.detach().cpu() for x in hit)))
        return hit

    monkeypatch.setattr(intersect, "intersect", recorded)
    img = diff.render_beauty(diff.apply_params(state, params), 0, cfg,
                             device=device)
    monkeypatch.setattr(intersect, "intersect", search)
    return img, params, hits


def _grads(loss, params):
    """(loss, {path: gradient as numpy}); a leaf no part of the loss reaches
    has zeros."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                             retain_graph=True)
    return float(loss.detach()), {
        p: (np.zeros(tuple(v.shape), np.float32) if g is None
            else g.cpu().numpy()) for (p, v), g in zip(params.items(), gs)}


@pytest.mark.cuda
@pytest.mark.parametrize("env_mode", [tenv.SOLID_COLOR, tenv.PHYSICAL_SUN])
def test_tiny_scene_gradients_on_card_match_cpu(cuda, env_mode,
                                                monkeypatch):
    """The reference's tiny gradient scene rendered free-running on the
    card and on the CPU: at most 2.5% of lanes hit another primitive on
    some search; over the pixels whose every lane agrees the loss against a
    seeded target holds to rtol 1e-4 and the gradient of each of six
    parameter groups (albedo, material parameter, background, sun
    intensity, sun direction, camera centre) within 2e-3 of its largest
    entry."""
    paths = ["scene.materials.albedo", "scene.materials.param",
             "env.background_color", "env.sun_intensity",
             "env.sun_direction", "cam.center"]
    target = torch.from_numpy(np.random.default_rng(8).uniform(
        0.0, 1.0, (16, 24, 3)).astype(np.float32))
    state, cfg = diff_cases.tiny_state(env_mode)
    runs = [_free_render(state, cfg, paths, dev, monkeypatch)
            for dev in (cuda, "cpu")]
    lanes, pixels = diff_cases.search_agreement(runs[0][2], runs[1][2],
                                                cfg.n_pixels)
    assert int((~lanes).sum()) <= 0.025 * lanes.numel()
    weight = pixels.reshape(cfg.height, cfg.width, 1).float()
    held = []
    for img, params, _ in runs:
        dt = img - target.to(img.device)
        w8 = weight.to(img.device)
        held.append(_grads((dt * dt * w8).sum() / (3 * w8.sum()), params))
    (loss_k, gk), (loss_p, gp) = held
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    for p in paths:
        rel = float(np.abs(gk[p] - gp[p]).max()) / (float(np.abs(gp[p]).max())
                                                     + 1e-6)
        assert rel <= 2e-3, (p, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, path, index, rtol", diff_cases.FD_CHECKS,
                         ids=[f"{m}-{p}[{i}]"
                              for m, p, i, _ in diff_cases.FD_CHECKS])
def test_finite_differences_on_card(cuda, mode, path, index, rtol):
    """The reference's five central finite-difference checks of the tiny
    gradient scene (tests/test_gradients.py) with autograd on the card."""
    state, cfg = diff_cases.tiny_state(getattr(tenv, mode))
    g, fd = diff_cases.fd_check(state, cfg, 0, path, index, device=cuda)
    assert diff_cases.fd_agrees(g, fd, rtol), (g, fd)


# The differentiable cell: the showcase at 400x225 @ 4 spp, depth 8, its
# sun low behind the camera. The sky's colours depend on the sun's height
# only between about -7.2 and +2.3 degrees of elevation (camera.hpp:
# 871-925; its azimuth shows only in the disc, which stays out of the
# frame). The fit starts with the sun FIT_SUN_DROP degrees lower, inside
# that band. The shader normalises the direction; stored at length
# DIFF_SUN_LENGTH, an Adam step of 2e-2 per component turns it by at most
# ~0.6 degrees, so 20 steps can cover the drop without Adam's momentum
# carrying the sun past +2.3 degrees, above which the image no longer
# depends on it. The fit's material has an interior albedo (0.1, 0.4, 0.9)
# and ~1,100 camera hits.
DIFF_SUN_ELEVATION, DIFF_SUN_AZIMUTH, DIFF_SUN_LENGTH = 1.16, 26.57, 2.0
FIT_SUN_DROP, FIT_MATERIAL, FIT_STEPS = 8.0, "light_blue_diffuse", 20


def _sun_vector(elevation: float):
    """The sun direction at `elevation` degrees and DIFF_SUN_AZIMUTH (from
    +x toward +z), stored at DIFF_SUN_LENGTH."""
    e, a = np.deg2rad(elevation), np.deg2rad(DIFF_SUN_AZIMUTH)
    return (float(DIFF_SUN_LENGTH * np.cos(e) * np.cos(a)),
            float(DIFF_SUN_LENGTH * np.sin(e)),
            float(DIFF_SUN_LENGTH * np.cos(e) * np.sin(a)))


def _sun_angle(v, truth) -> float:
    """The angle between v and truth, in degrees."""
    u, w = np.asarray(v, np.float64), np.asarray(truth, np.float64)
    u, w = u / np.linalg.norm(u), w / np.linalg.norm(w)
    return float(np.rad2deg(np.arccos(np.clip(u @ w, -1.0, 1.0))))


@pytest.mark.cuda
def test_differentiable_cell_fits_on_card(cuda):
    """The differentiable cell on the card: a forward and backward pass
    from the fit's start (FIT_MATERIAL's albedo blended 40% toward (0.2,
    0.8, 0.5), the sun FIT_SUN_DROP degrees lower) launches K4 and gives
    finite gradients, nonzero for the albedo and the sun's direction; then
    FIT_STEPS Adam steps (lr 2e-2, albedo clamped to [0, 1] off the
    emitters) at least halve the loss and turn the sun toward the truth."""
    import math

    from raytracer_project_tpu_torch import diff
    from raytracer_project_tpu_torch.models import materials as tmat
    from raytracer_project_tpu_torch.models.scene import SceneBuilder

    w, h = 400, 225
    scene = presets.showcase_scene().to(cuda)
    cam = tcam.make_camera(image_width=w, image_height=h, defocus_angle=0.0,
                           focus_dist=10.0, **CAM_KW).to(cuda)
    truth = _sun_vector(DIFF_SUN_ELEVATION)
    env = tenv.make_environment(sun_direction=truth,
                                sun_intensity=6.0).to(cuda)
    cfg = integrator.RenderConfig(
        width=w, height=h, samples_per_pixel=4, max_depth=8,
        env_mode=tenv.PHYSICAL_SUN, use_albedo=False, use_normal=False,
        use_z_depth=False, differentiable=True)
    state = diff.RenderState(scene, cam, env)
    # The showcase registers the reference's materials first, in this order.
    b = SceneBuilder()
    presets.load_reference_materials(b, np.random.default_rng(3))
    row = b.materials.get(FIT_MATERIAL)
    albedo = scene.materials.albedo.clone()
    albedo[row] = 0.6 * albedo[row] + 0.4 * albedo.new_tensor((0.2, 0.8, 0.5))
    start = diff.apply_params(state, {
        "scene.materials.albedo": albedo,
        "env.sun_direction": env.sun_direction.new_tensor(
            _sun_vector(DIFF_SUN_ELEVATION - FIT_SUN_DROP))})
    with torch.no_grad():
        target = diff.render_beauty(state, 5, cfg, device=cuda)
    paths = ["scene.materials.albedo", "scene.materials.param",
             "env.sun_direction"]
    loss_fn, p0 = diff.make_loss_fn(start, cfg, target, paths, device=cuda)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in p0.items()}
    k1.closest_hit_feats.launches = 0
    loss_fn(params, 5).backward()
    assert k1.closest_hit_feats.launches > 0
    for p in paths:
        assert torch.isfinite(params[p].grad).all(), p
    assert float(params["scene.materials.albedo"].grad.abs().max()) > 0
    assert float(params["env.sun_direction"].grad.abs().max()) > 0

    emissive = start.scene.materials.mtype == tmat.EMISSIVE
    suns = []

    def project(p):
        suns.append(_sun_angle(p["env.sun_direction"].tolist(), truth))
        a = p["scene.materials.albedo"]
        return {"scene.materials.albedo": torch.where(
            emissive[:, None], a, torch.clamp(a, 0.0, 1.0))}

    _, losses = diff.fit(start, 5, cfg, target,
                         ["scene.materials.albedo", "env.sun_direction"],
                         steps=FIT_STEPS, learning_rate=2e-2,
                         project=project, device=cuda)
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < 0.5 * losses[0]
    assert suns[-1] < _sun_angle(start.env.sun_direction.tolist(), truth)


def _aov_render(scene, cam, env, mode, spp, seed, width=96, height=54):
    """(beauty, albedo, normal) [height, width, 3] on the card from the
    fused pool with the albedo and normal AOVs, depth 8."""
    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp,
        max_depth=8, env_mode=mode, use_albedo=True, use_normal=True,
        use_z_depth=False, wavefront=True)
    out = integrator.render(scene, cam, env, seed, cfg, device="cuda")
    return out["beauty"], out["albedo"], out["normal"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["shirley", "cornell"])
def test_denoise_quality_gate_on_card(cuda, name):
    """The reference's denoise-quality gate (tests/test_denoise_quality.py)
    on the card: 96x54 at 8 spp against 384, through the fused pool's AOV
    kernels; the a-trous filter improves PSNR and SSIM on the raw render,
    the shipped U-Net by 2 dB and 0.04 (on the Cornell box by 6 dB, to an
    SSIM over 0.98); both denoisers' outputs on the card equal the CPU's
    within 1e-4 of the output's largest value."""
    from raytracer_project_tpu_torch.models import denoiser_unet
    from raytracer_project_tpu_torch.ops import denoise
    from raytracer_project_tpu_torch.utils import metrics

    if name == "shirley":
        scene = presets.shirley_final_scene(grid=5, with_bvh=False)
        cam = tcam.make_camera(image_width=96, image_height=54, vfov=20,
                               lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                               defocus_angle=0.0, focus_dist=10.0)
        env = tenv.make_environment(sun_direction=(0.4, 0.6, 0.2),
                                    sun_intensity=5.0)
        mode = tenv.PHYSICAL_SUN
    else:
        scene = presets.cornell_box_scene(with_bvh=False)
        cam = tcam.make_camera(image_width=96, image_height=54, vfov=40,
                               lookfrom=(278, 278, -800),
                               lookat=(278, 278, 0))
        env = tenv.make_environment(background_color=(0.0, 0.0, 0.0))
        mode = tenv.SOLID_COLOR
    scene = scene.to(cuda)
    model = denoiser_unet.load_default(device=cuda)
    assert model is not None, "the shipped denoiser weights are missing"
    ref, _, _ = _aov_render(scene, cam, env, mode, 384, 42)
    k1.closest_hit.launches = fs.shade_accumulate.features_launches = 0
    noisy, albedo, normal = _aov_render(scene, cam, env, mode, 8, 42)
    assert k1.closest_hit.launches > 0
    assert fs.shade_accumulate.features_launches > 0
    with torch.no_grad():
        at = denoise.atrous_denoise(noisy, albedo, normal)
        un = denoise.denoise(noisy, albedo, normal, model=model)
    p = {k: float(metrics.psnr(v, ref)) for k, v in
         (("raw", noisy), ("atrous", at), ("unet", un))}
    s = {k: float(metrics.ssim(v, ref)) for k, v in
         (("raw", noisy), ("atrous", at), ("unet", un))}
    assert p["atrous"] > p["raw"] and s["atrous"] > s["raw"], (p, s)
    assert p["unet"] > p["raw"] + 2.0 and s["unet"] > s["raw"] + 0.04, (p, s)
    if name == "cornell":
        assert p["unet"] > p["raw"] + 6.0 and s["unet"] > 0.98, (p, s)
    cpu_in = [x.cpu() for x in (noisy, albedo, normal)]
    with torch.no_grad():
        for card, cpu in ((at, denoise.atrous_denoise(*cpu_in)),
                          (un, denoiser_unet.load_default(device="cpu")(
                              *cpu_in))):
            assert float((card.cpu() - cpu).abs().max()) <= 1e-4 * float(
                cpu.abs().max())


@pytest.mark.cuda
def test_denoisers_finite_on_1080p_buffers(cuda):
    """Both denoisers, the a-trous filter and the shipped U-Net, on the
    showcase's 1920x1080 @ 8 spp buffers from the fused pool: outputs of
    the frame's shape, finite."""
    from raytracer_project_tpu_torch.models import denoiser_unet
    from raytracer_project_tpu_torch.ops import denoise

    scene = presets.showcase_scene().to(cuda)
    cam = tcam.make_camera(image_width=1920, image_height=1080, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    buf = _aov_render(scene, cam, env, tenv.PHYSICAL_SUN, 8, 1, 1920, 1080)
    model = denoiser_unet.load_default(device=cuda)
    assert model is not None, "the shipped denoiser weights are missing"
    with torch.no_grad():
        for out in (denoise.atrous_denoise(*buf), model(*buf)):
            assert out.shape == (1080, 1920, 3)
            assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_denoiser_trains_on_card(cuda, tmp_path):
    """A short training run on the card (tools/train_denoiser.py, 6 pairs,
    200 steps): the loss over the last 20 steps is below the first 20's,
    and the weights written load back through load_params into a U-Net
    whose output on seeded buffers is finite and the trained one's within
    1e-6 of its largest value."""
    from raytracer_project_tpu_torch.models import denoiser_unet
    from raytracer_project_tpu_torch.tools import train_denoiser

    res = train_denoiser.main(
        steps=200, pairs=6, out=str(tmp_path / "denoiser_weights.npz"),
        cache=str(tmp_path / "data"), device=cuda)
    losses = res["losses"]
    assert all(np.isfinite(losses))
    assert sum(losses[-20:]) < sum(losses[:20])
    loaded = denoiser_unet.DenoiserUNet(
        denoiser_unet.load_params(res["out"])).to(cuda)
    r = np.random.default_rng(3)
    bufs = [torch.from_numpy(r.uniform(0.0, 2.0, (54, 96, 3)).astype(
        np.float32)).to(cuda) for _ in range(3)]
    with torch.no_grad():
        a, b = res["model"](*bufs), loaded(*bufs)
    assert torch.isfinite(b).all()
    assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


@pytest.mark.cuda
def test_parity_gallery_on_card(cuda, tmp_path):
    """The parity gallery on the card: its 16 PNGs at 200x112 written and
    read back, at most one of them black."""
    from raytracer_project_tpu_torch.tools import make_parity_gallery
    from raytracer_project_tpu_torch.utils import image_io

    written = make_parity_gallery.main(["--out", str(tmp_path)])
    assert len(written) == 16
    lit = 0
    for path in written:
        img = image_io.read_png(path)
        assert img.shape == (112, 200, 3), path
        lit += int(img.max() > 0)
    assert lit >= 15


# --- the front end: the CLI, the session and the interactive loop ----------

FRONT_SIZE = (800, 450, 32, 4)          # width, height, spp, chunk


@pytest.fixture(scope="module")
def front(cuda):
    """What `render --preset showcase` at FRONT_SIZE renders on the card:
    (scene, camera, environment), its config, and the uninterrupted
    session of the frame in chunks."""
    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils.session import RenderSession

    w, h, spp, chunk = FRONT_SIZE
    scene, cam_kw = cli._preset("showcase")
    inputs = (scene.to(cuda),
              tcam.make_camera(image_width=w, image_height=h,
                               defocus_angle=0.0, focus_dist=10.0, **cam_kw),
              tenv.make_environment())
    cfg = integrator.RenderConfig(env_mode=tenv.PHYSICAL_SUN, width=w,
                                  height=h, samples_per_pixel=spp,
                                  max_depth=10)
    sess = RenderSession(*inputs, cfg, key=0, chunk_samples=chunk,
                         device="cuda")
    sess.render_progressive(spp)
    return inputs, cfg, sess


def _cli_sessions(monkeypatch):
    """The RenderSessions the CLI renders from now on."""
    from raytracer_project_tpu_torch.utils import session

    seen, real = [], session.RenderSession.render_progressive

    def progressive(sess, *args, **kw):
        seen.append(sess)
        return real(sess, *args, **kw)

    monkeypatch.setattr(session.RenderSession, "render_progressive",
                        progressive)
    return seen


@pytest.mark.cuda
def test_cli_render_on_card_matches_one_shot(front, tmp_path, monkeypatch):
    """`render` through cli.main at 800x450 @ 32 spp in chunks of 4 with
    four passes: K1 and K3 fused's feature variant launched, no plain
    version run, the four PNGs at the frame's size; the beauty PNG within
    1 LSB of the one-shot render's post-processed beauty on at least 99%
    of pixels, and each AOV's mean within 3e-4 of the one-shot's."""
    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.ops import post
    from raytracer_project_tpu_torch.utils import image_io
    from raytracer_project_tpu_torch.utils.session import to_u8

    inputs, cfg, _ = front
    w, h, spp, chunk = FRONT_SIZE
    passes = ("rgb", "albedo", "normals", "z_depth")
    argv = ["render", "--preset", "showcase", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--max-depth", "10", "--chunk",
            str(chunk), "--passes", ",".join(passes), "--out", str(tmp_path),
            "--checkpoint", str(tmp_path / "ck.npz"), "--quiet"]
    sessions = _cli_sessions(monkeypatch)
    plain_calls = _plain_calls(monkeypatch)
    k1.closest_hit.launches = fs.shade_accumulate.features_launches = 0
    assert cli.main(argv) == 0
    assert k1.closest_hit.launches > 0
    assert fs.shade_accumulate.features_launches > 0 and not plain_calls
    pngs = {name: image_io.read_png(str(tmp_path / f"render_{name}.png"))
            for name in passes}
    assert all(img.shape == (h, w, 3) for img in pngs.values())
    sess = sessions[0]
    one = integrator.render(*inputs, 0, cfg, device="cuda")
    pc = post.PostConfig()
    params = sess.post_params._replace(exposure=post.auto_exposure(
        sess.post_params, post.analyze_framebuffer(one["beauty"]), pc))
    want = to_u8(post.update_post_processing(one["beauty"], params, pc,
                                             post.PASS_RGB))
    over = (np.abs(pngs["rgb"].astype(int) - want.astype(int)).max(-1) > 1)
    assert over.mean() <= 0.01
    got = sess.buffers()
    for name in ("albedo", "normal", "z_depth"):
        a, b = float(got[name].mean()), float(one[name].mean())
        assert abs(a - b) <= 3e-4 * abs(b), name


@pytest.mark.cuda
def test_cli_resume_on_card(front, tmp_path, monkeypatch):
    """A 16 spp checkpoint of the frame, finished by `render --resume` in a
    fresh session: four chunks of 4 after the restore, its checkpoint at
    32 samples holding the uninterrupted session's sums within rtol/atol
    3e-4."""
    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils.session import RenderSession

    inputs, cfg, full = front
    w, h, spp, chunk = FRONT_SIZE
    half = RenderSession(*inputs, cfg, key=0, chunk_samples=chunk,
                         device="cuda")
    half.render_progressive(spp // 2)
    ck = str(tmp_path / "ck.npz")
    half.checkpoint(ck)
    argv = ["render", "--preset", "showcase", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--max-depth", "10", "--chunk",
            str(chunk), "--passes", "rgb", "--out", str(tmp_path), "--checkpoint",
            ck, "--resume", "--quiet"]
    sessions = _cli_sessions(monkeypatch)
    calls = []
    real = integrator.accumulate_samples
    monkeypatch.setattr(integrator, "accumulate_samples",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert cli.main(argv) == 0
    assert len(calls) == (spp // 2) // chunk
    assert any("Restored 16 samples" in e for e in sessions[0].log.entries)
    with np.load(ck) as data:
        assert int(data["samples_done"]) == spp
        got = [torch.as_tensor(data[f])
               for f in integrator.SampleBuffers._fields]
    for name, a, b in zip(integrator.SampleBuffers._fields, got, full.acc):
        torch.testing.assert_close(a, b.cpu(), rtol=3e-4, atol=3e-4, msg=name)


@pytest.mark.cuda
def test_session_over_a_mesh_of_one_card(front):
    """A session over a mesh of cuda:0 listed 4 times (a thread a window)
    sums as the single-device session within rtol/atol 3e-4."""
    from raytracer_project_tpu_torch.utils.session import RenderSession

    inputs, cfg, full = front
    meshed = RenderSession(*inputs, cfg, key=0, chunk_samples=FRONT_SIZE[3],
                           mesh=[torch.device("cuda", 0)] * 4, device="cuda")
    meshed.render_progressive(cfg.samples_per_pixel)
    for name, a, b in zip(integrator.SampleBuffers._fields, meshed.acc,
                          full.acc):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-4, msg=name)


@pytest.mark.cuda
def test_interactive_loop_on_card(cuda, tmp_path):
    """`interactive` at its default 400x225 with a preview PNG, fed a
    command script: a post edit keeps the session and its samples, a
    camera edit restarts it, the sun line syncs, `wire` launches K4, quit
    stops the loop, the preview and every pass of `saveall` are written."""
    import io

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils import image_io
    from raytracer_project_tpu_torch.utils.interactive import InteractiveLoop

    preview = str(tmp_path / "preview.png")
    script = ("set post.exposure 1.5\npass albedo\nstats\npass rgb\n"
              "wire 2\nset camera.vfov 35\nsun 45 172 12\n"
              f"saveall {tmp_path / 'all'}\nquit\n")
    loop = cli.build_interactive(cli._build_parser().parse_args(
        ["interactive", "--watch", preview]))
    loop.log.echo = False
    assert (loop.config.width, loop.config.height) == (400, 225)
    loop.tick()
    loop.tick()
    record, commands = [], []

    def tick():
        notes = InteractiveLoop.tick(loop)
        record.append((commands[-1] if commands else "",
                       loop.session.samples_done, id(loop.session)))
        return notes

    def handle(line):
        commands.append(line.strip())
        return InteractiveLoop.handle_command(loop, line)

    loop.tick, loop.handle_command = tick, handle
    out = io.StringIO()
    k1.closest_hit_feats.launches = 0
    loop.run(stdin=io.StringIO(script), max_ticks=40, out=out)
    ticks = {c: i for i, (c, _, _) in enumerate(record)}
    i = ticks["set post.exposure 1.5"]
    assert record[i][2] == record[i - 1][2]
    assert record[i][1] == record[i - 1][1] + 2
    j = ticks["set camera.vfov 35"]
    assert record[j][2] != record[j - 1][2] and record[j][1] == 2
    assert "[Config] sun synced" in out.getvalue()
    assert image_io.read_png(preview).shape == (225, 400, 3)
    assert k1.closest_hit_feats.launches > 0
    assert not loop.running
    for name in ("rgb", "albedo", "normals", "reflections", "refractions",
                 "z_depth"):
        assert (tmp_path / "all" / f"render_{name}.png").exists(), name


@pytest.mark.cuda
def test_cli_numerics_info_and_profile_on_card(cuda, tmp_path, capsys):
    """`render --check-numerics` on a 16x9 frame is clean; the NaN trap
    raises on the card and names the op; `info` names the card and not
    JAX; `render --profile` writes a trace that holds CUDA kernels and no
    index_add_."""
    import json

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils import debug

    assert cli.main(["render", "--width", "16", "--height", "9", "--spp",
                     "1", "--out", str(tmp_path / "numerics"),
                     "--check-numerics"]) == 0
    assert "check-numerics pass clean" in capsys.readouterr().out
    x = torch.linspace(0.0, 4.0, 9, device=cuda)
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        debug.checked(lambda v: torch.where(v < 2.0, 0.0,
                                            torch.sqrt(v - 2.0)))(x)
    assert cli.main(["info"]) == 0
    text = capsys.readouterr().out
    info = json.loads(text)
    assert info["cuda_available"] and info["card"]
    assert "jax" not in text.lower()
    prof = tmp_path / "profile"
    assert cli.main(["render", "--width", "64", "--height", "36", "--spp",
                     "2", "--chunk", "2", "--out", str(prof), "--profile",
                     str(prof), "--quiet"]) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert sum(ev.get("cat") == "kernel" for ev in events) > 0
    assert not [ev.get("name") for ev in events
                if "index_add" in ev.get("name", "")
                or "indexFunc" in ev.get("name", "")]
