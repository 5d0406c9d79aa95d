"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the reference package, so it also runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
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
from raytracer_project_tpu_torch.ops import intersect, traverse
from raytracer_project_tpu_torch.tools import goldens
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
    """The fused render launches K1 and K3 fused, K1 on the compact rows
    only, and neither K2, the unfused K3 nor an index_add_."""
    from torch.profiler import ProfilerActivity, profile

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
    assert "closest_hit_od" in entries
    assert not [e for e in entries if e.endswith("_dense")]


# K3 fused on random path states over real hits: beauty with one lane per
# pixel, the variant with fog, every AOV and both passes, and a pixel
# window with spec lanes.
FUSED_CASES = ("beauty", "features", "window")


def _fused_step_inputs(inputs, case):
    """(tables, hits, aparams, bparams, sp, state_f, state_i, next_work,
    segments) of one K3 fused step on the card at P lanes."""
    scene, env, od = inputs
    dev = od.device
    r = np.random.default_rng(3)
    features = case == "features"
    spec = case != "beauty"
    if features:
        scene = presets.showcase_scene(use_fog=True,
                                       fog_density=0.05).to(dev)
    tables = fs.build_tables(scene, env.to(dev), tenv.PHYSICAL_SUN)
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
        env_mode=tenv.PHYSICAL_SUN, aux=3, z_max=50.0,
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
    tables, hits, aparams, bparams, sp, sf, si, nw, seg = _fused_step_inputs(
        inputs, case)
    dev = sf.device
    accs, outs = [], []
    for fn in (fs.shade_accumulate, fs.shade_accumulate_plain):
        acc = fs.new_accumulator(sp, dev)
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        outs.append(fn(tables, hits, sf, si, nw, seg, steps, aparams,
                       bparams, sp, acc))
        accs.append(acc.view(len(fs.acc_channels(sp)), sp.n_pixels + 1))
    (out, ref), n = outs, sp.n_pixels
    bad = torch.zeros(P, dtype=torch.bool, device=dev)
    for a, b in zip(out[:2], ref[:2]):
        if a.dtype.is_floating_point:
            bad |= ~torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
        else:
            bad |= (a != b).any(0)
    assert float(bad.float().mean()) <= (0.005 if case == "features" else 0.0)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[si[3][bad].long() - sp.pixel_offset] = False
    torch.testing.assert_close(accs[0][:, :n][:, keep],
                               accs[1][:, :n][:, keep], rtol=1e-5, atol=1e-5)
    assert not accs[0][:, n].any()
    assert bool((accs[0][:, :n].abs().sum(1) > 0).all())
    assert int(out[3]) == int(ref[3]) and int(out[5]) == int(ref[5]) == 1
    if not bool(bad.any()):
        assert torch.equal(out[2], ref[2]) and torch.equal(out[4], ref[4])
    li = out[1][3]
    assert bool(((li >= sp.pixel_offset)
                 & (li < sp.pixel_offset + n)).all())


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


# --- the kernel probes (raytracer_project_tpu_torch/tools) -----------------

def _finite_t_equal(t, ref, od):
    """t equals ref bit for bit on every lane whose features are finite."""
    feats = intersect.ray_feature_rows(od[:3].T, od[3:].T)
    finite = torch.isfinite(feats[:13]).all(0)
    return torch.equal(t[finite].view(torch.int32),
                       ref[finite].view(torch.int32))


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
        assert _finite_t_equal(t, k1.closest_hit(od, 0.0, tables)[0], od)


@pytest.mark.cuda
def test_ablation_full_equals_k1_on_bounce_rays(cuda):
    """On 16,384 showcase bounce rays at tmin 1e-3, P1 `full` and `nocull`
    equal K1's t bit for bit on every lane with finite features."""
    scene, od = _showcase_bounce_rays(cuda)
    tables = k1.scan_tables(scene)
    tk = k1.closest_hit(od, 1e-3, tables)[0]
    assert int((tk < 1e30).sum()) > od.shape[1] // 10
    for v in ("full", "nocull"):
        assert _finite_t_equal(pa.ablate(od, 1e-3, tables, v)[0], tk, od), v


@pytest.mark.cuda
@pytest.mark.parametrize("variant", pa.VARIANTS)
def test_ablation_dense_kernel_matches_plain(cuda, variant):
    """The dense yardstick (probe_a1_ablate_dense) on 16,384 of the probe's
    rays against its plain version grouped per warp over 512-wide chunks
    (pa.compare's budgets); `full` equals the dense K1's t and `nocull`."""
    scene = presets.showcase_scene().to(cuda)
    coeffs, bounds, counts = pa.scene_tables(scene)
    od = pa.make_rays(16_384, 1, cuda)
    pa.ablate_dense.launches = 0
    t, idx, typ = pa.ablate_dense(od, 0.0, coeffs, bounds, counts, variant)
    assert pa.ablate_dense.launches == 1
    assert not idx.any() and not typ.any()
    ref = pa.ablate_plain(od, 0.0, coeffs, bounds, counts, variant)[0]
    stats = pa.compare(variant, t, ref)
    assert stats["ok"], stats
    if variant == "full":
        tk = k1.closest_hit_dense(od, 0.0, coeffs, bounds, counts)[0]
        assert torch.equal(t, tk)
        nocull = pa.ablate_dense(od, 0.0, coeffs, bounds, counts, "nocull")[0]
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


def _bits(out):
    """The f32 result of a fetch (a tensor or a tuple of them) as i32 [n, p]."""
    if isinstance(out, torch.Tensor):
        return out.view(torch.int32)
    return torch.stack(out).view(torch.int32) if out else torch.zeros(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [0, 1, 7, 24, 28, 29, 32])
@pytest.mark.parametrize("mode", tuple(po.MODES))
def test_onehot_fetch_kernel_matches_yardstick(cuda, mode, n_out):
    """The fetch kernel as its entry chooses, in place and with its table
    staged in shared memory, and the first port's kernel (the yardstick)
    against the plain version, bit for bit, on 65,537 lanes (not a
    multiple of a block) with rows outside the table, at output counts on
    both sides of the 28 columns."""
    t, idx, table = po.make_inputs(1536, 65_537, bool(po.MODES[mode][1]),
                                   seed=3, device=cuda)
    ref = _bits(po.onehot_fetch_plain(t, idx, table, n_out, mode))
    po.onehot_fetch.launches = po.onehot_fetch_scalar.launches = 0
    outs = [po.onehot_fetch(t, idx, table, n_out, mode),
            po.onehot_fetch(t, idx, table, n_out, mode, staged=False),
            po.onehot_fetch_scalar(t, idx, table, n_out, mode)]
    if mode != "plain":
        outs.append(po.onehot_fetch(t, idx, table, n_out, mode, staged=True))
    assert po.onehot_fetch_scalar.launches == 1
    assert po.onehot_fetch.launches == len(outs) - 1
    for out in outs:
        assert torch.equal(_bits(out), ref)


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
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_decode_stage_kernel_matches_yardstick(cuda, stage, shuffle):
    """P3's stage kernel against the first port's kernel (the yardstick),
    bit for bit on every row and lane, on K1's hits of the showcase camera
    rays in pool order and shuffled from a seed, so that warps mix the
    primitive types."""
    tables, od, hit, _ = pd.camera_hits(65_536, cuda)
    if shuffle:
        perm = torch.randperm(65_536, generator=torch.Generator().manual_seed(7))
        perm = perm.to(cuda)
        od = od[:, perm].contiguous()
        hit = tuple(x[perm].contiguous() for x in hit)
    pd.decode_stage.launches = pd.decode_stage_scalar.launches = 0
    out = pd.decode_stage(stage, tables, od, *hit)
    ref = pd.decode_stage_scalar(stage, tables, od, *hit)
    assert pd.decode_stage.launches == pd.decode_stage_scalar.launches == 1
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


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
def test_scene_golden_on_card(cuda, name, engine):
    """The goldens past the showcase through integrator.render on the card,
    on either engine (K4, or K1-K3), against the reference's CPU goldens
    under the cross-backend budgets."""
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
    the 5e-2 cap (chip_smoke.py hit_agree)."""
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
    tk, ik, yk = k1.closest_hit(od, 1e-3, tables)
    tp, ip, yp = k1.closest_hit_plain(od, 1e-3, tables.coeffs, tables.counts)
    hk, hp = tk < 1e30, tp < 1e30
    assert int(hk.sum()) > P // 10
    assert int((hk != hp).sum()) <= P // 100
    same = hk & hp & (ik == ip) & (yk == yp)
    assert int((hk & hp & ~same).sum()) <= P // 40
    near = ((first.hit & (ik == first.prim_idx) & (yk == first.prim_type))
            | (torch.minimum(tk, tp) < 0.02))
    held = same & ~near
    rel = ((tk - tp).abs() / tp.abs().clamp(min=1e-3))
    assert float((rel[same] > 5e-3).float().mean()) <= 0.03
    assert float(rel[held].max()) <= 5e-2


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
    through the unfused pool (K1 only) against smoke_pool_128x72.npz under
    the cross-backend budgets 0.06 / 0.20."""
    monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
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
    assert fs.shade_accumulate.launches == 0
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
    _hit_budgets(tk, ik, yk, tp, ip, yp)
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
    from raytracer_project_tpu_torch.tools import diff_cases

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
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(_bits(a), _bits(b)), k


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

def _bvh_funnel_rays(cuda, n=131_072):
    """The funnel (25,090 primitives) with its pool tables (BVH attached) on
    the card, and n bounce lanes: one scatter of the 800x450 funnel camera's
    rays at their first hits, and what each lane left (index, type, hit)."""
    from raytracer_project_tpu_torch.ops import shade

    scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2,
                                     with_bvh=False).to(cuda)
    scan = fs.build_tables(scene, tenv.make_environment(**ENV_KW).to(cuda),
                           tenv.PHYSICAL_SUN).scan
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **FUNNEL_CAM).to(cuda)
    pix = torch.arange(800 * 450, device=cuda)[:n]
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    od = torch.cat([sc.origin.T, sc.direction.T]).contiguous()
    return scene, scan, od, (first.prim_idx, first.prim_type, first.hit)


def _against_k1(tb, ib, yb, tk, ik, yk, n):
    """The BVH kernel against K1's tile scan: t bit for bit on every lane
    where both chose the same primitive, the rest within the reference's
    budgets; returns (hits, hit flips, winner flips)."""
    hb, hk = tb < 1e30, tk < 1e30
    both = hb & hk
    same = both & (ib == ik) & (yb == yk)
    assert torch.equal(tb[same], tk[same])
    flips, winner = int((hb != hk).sum()), int((both & ~same).sum())
    assert flips <= max(2, n // 100) and winner <= max(2, n // 40)
    return int(both.sum()), flips, winner


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
    hits, flips, winner = _against_k1(tb, ib, yb, tk, ik, yk, n)
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
    hits, flips, winner = _against_k1(tb, ib, yb, tk, ik, yk, P)
    print(f"showcase lanes {P}: hits {hits}, hit flips {flips}, "
          f"winner flips {winner}")
    assert hits > P // 4


def _grazing(scene, o, d, t, idx, typ):
    """Lanes whose hit is met so nearly tangentially that f32 cannot resolve
    t to 5e-2 (chip_smoke.py near_tangent): an error of 8 ulps of the
    largest term each formulation sums, carried to t in f64 -- a sphere's
    c = |o|^2 - 2 o.C + |C|^2 - r^2 moves a root by dc / (2 sqrt(disc)); a
    triangle's t = (o - v0).n / (-d.n) by the numerator's and the
    denominator's errors over |d.n|."""
    from raytracer_project_tpu_torch.models.geometry import (
        PRIM_SPHERE, PRIM_TRIANGLE)

    f64, ulps = torch.float64, 8 * 2.0 ** -23
    o64, d64, t64 = o.to(f64), d.to(f64), t.to(f64).abs()
    norm = lambda x: torch.sqrt((x * x).sum(-1))
    sph, tri = typ == PRIM_SPHERE, typ == PRIM_TRIANGLE
    row = torch.where(sph, idx, 0).long()
    c = scene.spheres.center[row].to(f64)
    r = scene.spheres.radius[row].to(f64)
    oc = c - o64
    h = (d64 * oc).sum(-1)
    disc = h * h - (d64 * d64).sum(-1) * ((oc * oc).sum(-1) - r * r)
    mag = (o64 * o64).sum(-1) + (c * c).sum(-1) + r * r
    dt_sph = ulps * mag / (2.0 * torch.sqrt(disc.clamp(min=1e-300)))
    row = torch.where(tri, idx, 0).long()
    v0 = scene.triangles.v0[row].to(f64)
    n = torch.linalg.cross(scene.triangles.e1[row].to(f64),
                           scene.triangles.e2[row].to(f64), dim=-1)
    det = (d64 * n).sum(-1).abs().clamp(min=1e-300)
    dt_tri = ulps * norm(n) * (norm(o64) + norm(v0) + t64 * norm(d64)) / det
    dt = torch.where(sph, dt_sph, torch.where(tri, dt_tri, 0.0))
    return (t < 1e30) & (dt > 5e-2 * t64)


@pytest.mark.cuda
def test_bvh_kernel_matches_its_plain_traversal(cuda):
    """The kernel against its plain version (the threaded traversal of
    ops/traverse.py, on the card) on the funnel's bounce lanes, under the
    reference's budgets; a lane that hits the primitive it left, within
    0.02 of its origin (the funnel's spheres overlap), or so nearly
    tangentially that f32 cannot resolve t (`_grazing`), counts in the 3%
    budget but not under the 5e-2 cap: each formulation's rounding decides
    such a root."""
    scene, scan, od, left = _bvh_funnel_rays(cuda, n=65_536)
    tb, ib, yb = k1.bvh_closest_hit(od, 1e-3, scan)
    tp, ip, yp = k1.bvh_closest_hit_plain(od, 1e-3, scan.bvh)
    n = od.shape[1]
    hb, hp = tb < 1e30, tp < 1e30
    assert int(hb.sum()) > n // 10
    assert int((hb != hp).sum()) <= n // 100
    both = hb & hp
    same = both & (ib == ip) & (yb == yp)
    assert int((both & ~same).sum()) <= n // 40
    near = ((left[2] & (ib == left[0]) & (yb == left[1]))
            | (torch.minimum(tb, tp) < 0.02)
            | _grazing(scene, od[:3].T, od[3:].T, tb, ib, yb))
    rel = (tb - tp).abs() / tp.abs().clamp(min=1e-3)
    assert float((rel[same] > 5e-3).float().mean()) <= 0.03
    assert float(rel[same & ~near].max()) <= 5e-2


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
