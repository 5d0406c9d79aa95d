"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import fused_step as fs
from raytracer_project_tpu_torch.ops import integrator
from raytracer_project_tpu_torch.ops import intersect
from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
from raytracer_project_tpu_torch.tools import probe_decode as pd
from raytracer_project_tpu_torch.tools import probe_onehot as po

torch.set_num_threads(2)

CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0,
              hdr_image=HDR, hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1)
INT_ROWS = (fs._RO_HIT, fs._RO_FRONT, fs._RO_MTYPE, fs._RO_GU, fs._RO_GV,
            fs._RO_HASB, fs._RO_TEXROW, fs._RO_BUMPROW, fs._RO_ENVROW)
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
    tk, ik, yk = k1.closest_hit(od, 1e-3, tables.scan)
    _hit_budgets(tk, ik, yk, *k1.closest_hit_plain(od, 1e-3,
                                                   tables.scan.coeffs,
                                                   tables.scan.counts))


def _hit_budgets(tk, ik, yk, tp, ip, yp):
    """The reference's closest-hit agreement budgets (utils/smoke.py:351-359)."""
    hk, hp = tk < 1e30, tp < 1e30
    assert int((hk != hp).sum()) <= P // 100
    both = hk & hp
    same = both & (ik == ip) & (yk == yp)
    assert int((both & ~same).sum()) <= P // 40
    rel = ((tk - tp).abs() / tp.abs().clamp(min=1e-3))[same]
    assert float((rel > 5e-3).float().mean()) <= 0.03
    assert float(rel.max()) <= 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP])
def test_decode_kernel_matches_plain(inputs, env_mode):
    scene, env, od = inputs
    tables = fs.build_tables(scene, env.to(od.device), env_mode)
    aparams = fs._aparams(env, od.device)
    hit = k1.closest_hit(od, 1e-3, tables.scan)
    out = fs.decode(tables, od, *hit, aparams).cpu()
    ref = fs.decode_plain(tables, od, *hit, aparams).cpu()
    for k in range(fs._RO_ROWS):
        if k in INT_ROWS:
            assert torch.equal(out[k], ref[k]), k
        else:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-5)


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
    _hit_budgets(*out, *ref)
    _hit_budgets(*out, *k1.closest_hit(od, 1e-3, tables.scan))


def _record_entries(monkeypatch):
    """The C entries launched from now on, in order."""
    seen = []
    real = kernels.launch
    monkeypatch.setattr(kernels, "launch",
                        lambda entry, *a: seen.append(entry) or real(entry, *a))
    return seen


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
    ref = fs.shade_advance_plain(tables, *args)
    for k, (a, b) in enumerate(zip(out, ref)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b), k
    assert int(out[4]) == sp.total_work


@pytest.mark.cuda
def test_render_goes_through_the_kernels(cuda, monkeypatch):
    """The fused render launches K1-K3, K1 on the compact rows only."""
    entries = _record_entries(monkeypatch)
    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=64, height=36, samples_per_pixel=2,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False)
    for fn in (k1.closest_hit, fs.decode, fs.shade_advance):
        fn.launches = 0
    out, stats = integrator.render(scene, cam, env, 0, cfg, with_stats=True)
    assert out["beauty"].device.type == "cuda"
    assert all(fn.launches > 0 for fn in (k1.closest_hit, fs.decode,
                                          fs.shade_advance))
    assert stats["steps"] > 0 and stats["segments"] > 0
    img = out["beauty"].cpu()
    assert torch.isfinite(img).all() and img.max() > 0
    assert "closest_hit_od" in entries
    assert not [e for e in entries if e.endswith("_dense")]


@pytest.mark.cuda
def test_chunked_render_goes_through_k4(cuda, monkeypatch):
    """The chunked integrator on the card launches K4 for every closest hit
    and never runs a plain version; all six buffers come back finite."""
    plain_calls = []
    for mod, name in ((k1, "closest_hit_plain"), (k1, "closest_hit_feats_plain"),
                      (fs, "decode_plain"), (fs, "shade_advance_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain_calls.append(_n))
    entries = _record_entries(monkeypatch)
    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=32, image_height=18, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=32, height=18, samples_per_pixel=2,
                                  use_reflection=True, use_refraction=True,
                                  wavefront=False)
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
    assert out["beauty"].max() > 0


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
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    for a, b in zip(out[:4], ref[:4]):
        assert a.shape == b.shape
        if a.dtype.is_floating_point:
            bad |= ~torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
        else:
            bad |= (a != b).any(0)
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
                      (fs, "shade_advance_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            plain_calls.append(_n))
    fs.shade_advance.features_launches = 0
    card = integrator.render(scene, cam, env, 0, cfg)
    assert not plain_calls and fs.shade_advance.features_launches > 0
    for name, ref in cpu.items():
        img = card[name].cpu().numpy()
        d = np.abs(img - ref.numpy())
        assert np.isfinite(img).all(), name
        assert d.mean() <= 0.06 and (d.max(-1) > 0.05).mean() <= 0.20, name


# --- the kernel probes (raytracer_project_tpu_torch/tools) -----------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", pa.VARIANTS)
def test_ablation_kernel_matches_plain(cuda, variant):
    """P1 on 16,384 of the probe's rays against its plain version grouped
    per warp (pa.compare's budgets); `full` equals K1's t bit for bit (the
    same fmaf dots and per-warp cull over the same columns) and `nocull`."""
    scene = presets.showcase_scene().to(cuda)
    coeffs, bounds, counts = pa.scene_tables(scene)
    od = pa.make_rays(16_384, 1, cuda)
    pa.ablate.launches = 0
    t, idx, typ = pa.ablate(od, 0.0, coeffs, bounds, counts, variant)
    assert pa.ablate.launches == 1
    assert not idx.any() and not typ.any()
    ref = pa.ablate_plain(od, 0.0, coeffs, bounds, counts, variant, pa.WARP)[0]
    stats = pa.compare(variant, t, ref)
    assert stats["ok"], stats
    if variant == "full":
        tk = k1.closest_hit(od, 0.0, k1.scan_tables(scene))[0]
        assert torch.equal(t, tk)
        nocull = pa.ablate(od, 0.0, coeffs, bounds, counts, "nocull")[0]
        assert torch.equal(t, nocull)


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
    ref = po.onehot_fetch_plain(t, idx, table, 24, mode)
    if po.MODES[mode][2]:
        assert out.shape == (24, 65_536) and torch.equal(out, ref)
    else:
        assert len(out) == 24
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


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
    float_rows = () if stage == 0 else tuple(range(2, 11)) + (12, 13)
    for k in range(fs._RO_ROWS):
        if k in float_rows:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(out[k], ref[k]), k
