"""The closest hit's compact coefficient rows (ops/closest_hit.py
scan_tables, the tables of csrc/closest_hit.cu's closest_hit_od and
closest_hit_feats) on the CPU: the structural slot lists hold on the
reference package's own tables, compaction refuses a stray nonzero, the
sparse fmaf chain equals the dense 16-term chain bit for bit on finite
features, a render builds the tables once per scene, and no closest hit
of a retired lane reaches a buffer."""

import types

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import intersect as jis
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.core import vecmath
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import integrator
from raytracer_project_tpu_torch.ops import intersect as tis

torch.set_num_threads(2)

TYPES = ("sphere", "tri", "box")


def _seeded_tables(seed=5):
    """Sphere, triangle and box tables made with numpy from a seed: the
    r=1000 ground sphere, an r <= 0 sphere, a zero-area triangle and boxes
    under random rotations and scales."""
    r = np.random.default_rng(seed)
    ns, nt, nb = 40, 70, 30
    center = r.uniform(-10, 10, (ns, 3)).astype(np.float32)
    radius = r.uniform(0.1, 2.0, ns).astype(np.float32)
    center[0], radius[0] = (0.0, -1000.0, 0.0), 1000.0
    radius[7] = -0.5
    v0 = r.uniform(-5, 5, (nt, 3)).astype(np.float32)
    e1 = r.normal(size=(nt, 3)).astype(np.float32)
    e2 = r.normal(size=(nt, 3)).astype(np.float32)
    e2[11] = 2.0 * e1[11]
    q = np.linalg.qr(r.normal(size=(nb, 3, 3)))[0]
    m = q * r.uniform(0.3, 2.0, (nb, 1, 3))            # world <- local, R S
    minv = np.linalg.inv(m)
    pos = r.uniform(-8, 8, (nb, 3))
    trans = -np.einsum("bij,bj->bi", minv, pos)
    ext = np.abs(m).sum(-1)
    spheres = types.SimpleNamespace(center=center, radius=radius, count=ns)
    tris = types.SimpleNamespace(v0=v0, e1=e1, e2=e2, count=nt)
    boxes = types.SimpleNamespace(
        mat=np.zeros(nb, np.int32), count=nb,
        minv=minv.reshape(nb, 9).astype(np.float32),
        trans=trans.astype(np.float32),
        aabb_min=(pos - ext).astype(np.float32),
        aabb_max=(pos + ext).astype(np.float32))
    return spheres, tris, boxes


@pytest.fixture(scope="module")
def scenes():
    """(reference tables as numpy, the port's scene) for the showcase and
    the seeded scene."""
    js = jpresets.showcase_scene(with_bvh=False)
    sph, tri, box = _seeded_tables()
    seeded = types.SimpleNamespace(
        mm=tis.build_mm_tables(sph, tri, box).to("cpu"), spheres=sph,
        triangles=tri, boxes=box)
    return {"showcase": (js.mm, tpresets.showcase_scene()),
            "seeded": (jis.build_mm_tables(sph, tri, box), seeded)}


def _coeffs(mm):
    return tuple(torch.as_tensor(np.array(c)) for c in
                 (mm.sphere_coeff, mm.tri_coeff, mm.box_coeff))


@pytest.mark.parametrize("name", ["showcase", "seeded"])
def test_slots_hold_on_reference_tables(scenes, name):
    """Every coefficient outside the slot lists is 0 in the reference's
    tables, and the compact rows gathered from them equal the port's."""
    jmm, tscene = scenes[name]
    port = k1.scan_tables(tscene)
    for coeff, n, slots, width, rows, kind in zip(
            _coeffs(jmm), port.counts, k1.SLOTS, k1.ROW_WIDTHS, port.rows,
            TYPES):
        assert n > 0, kind
        listed = np.zeros(coeff.shape[:2], bool)
        for g, ks in enumerate(slots):
            listed[list(ks), g] = True
        assert not coeff[:, :, :n].numpy()[~listed].any(), kind
        ref = k1.compact_rows(coeff, n, slots, width)
        assert ref.shape == rows.shape == (n, width), kind
        assert torch.equal(ref, rows), kind
        assert not rows[:, sum(map(len, slots)):].any(), kind


@pytest.mark.parametrize("kind", TYPES)
def test_compaction_raises_on_stray_nonzero(scenes, kind):
    """One nonzero coefficient outside the slot lists, in a scanned column,
    makes compaction raise; past the count it is not read."""
    _, tscene = scenes["showcase"]
    i = TYPES.index(kind)
    coeff = _coeffs(tscene.mm)[i].clone()
    n = k1.scan_tables(tscene).counts[i]
    k = 12 if kind != "tri" else 9       # |d|^2 and o.d: never a slot there
    coeff[k, 0, n - 1] = 1e-7
    with pytest.raises(ValueError, match="structural zero"):
        k1.compact_rows(coeff, n, k1.SLOTS[i], k1.ROW_WIDTHS[i])
    k1.compact_rows(coeff, n - 1, k1.SLOTS[i], k1.ROW_WIDTHS[i])


@pytest.mark.parametrize("name", ["showcase", "seeded"])
def test_sparse_chain_equals_dense_chain(scenes, name):
    """The fmaf chain over a compact row's slots in ascending k equals the
    dense 16-term chain from +0, bit for bit, on seeded finite features of
    camera-like and bounce-like rays (the r=1000 ground sphere included)."""
    _, tscene = scenes[name]
    tables = k1.scan_tables(tscene)
    r = np.random.default_rng(11)
    m = 128
    o = np.concatenate([np.tile(np.float32([12.0, 2.5, 6.0]), (m, 1)),
                        r.uniform(-8, 8, (m, 3))]).astype(np.float32)
    d = np.concatenate([r.uniform(-1, 1, (m, 3)) - [1.0, 0.2, 0.5],
                        r.normal(size=(m, 3))]).astype(np.float32)
    f = tis.ray_features(tuple(torch.as_tensor(o[:, k]) for k in range(3)),
                         tuple(torch.as_tensor(d[:, k]) for k in range(3)))
    assert torch.isfinite(f).all()
    for coeff, rows, n, slots in zip(tables.coeffs, tables.rows,
                                     tables.counts, k1.SLOTS):
        q = 0
        for g, ks in enumerate(slots):
            dense = torch.zeros((f.shape[0], n))
            for k in range(16):
                dense = vecmath.fma(f[:, k:k + 1], coeff[k, g, :n][None], dense)
            sparse = torch.zeros((f.shape[0], n))
            for k in ks:
                sparse = vecmath.fma(f[:, k:k + 1], rows[:, q][None], sparse)
                q += 1
            assert torch.equal(sparse, dense), (g, ks)


def test_tables_built_once_per_scene(monkeypatch):
    """A fused render and a chunked render each build the closest-hit
    tables once, not once per launch."""
    built, scans = [], []
    for name, log in (("scan_tables", built), ("closest_hit_plain", scans),
                      ("closest_hit_feats_plain", scans)):
        monkeypatch.setattr(k1, name, lambda *a, _f=getattr(k1, name),
                            _log=log: _log.append(1) or _f(*a))
    scene = tpresets.showcase_scene(grid=2, with_meshes=False)
    cam = tcam.make_camera(image_width=8, image_height=6, vfov=30.0,
                           lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    for wavefront in (True, False):
        built.clear()
        scans.clear()
        cfg = integrator.RenderConfig(width=8, height=6, samples_per_pixel=2,
                                      max_depth=3, wavefront=wavefront)
        integrator.render(scene, cam, env, 0, cfg, device="cpu")
        assert len(scans) > 1, (wavefront, len(scans))
        assert len(built) == 1, (wavefront, len(built))


def test_retired_lanes_hits_reach_no_buffer(monkeypatch):
    """K1 and K4 leave unspecified what a lane with non-finite features
    gets. The chunked bounce loop intersects retired lanes too, so such a
    lane's answer must reach no buffer: retired lanes with infinite or NaN
    rays, whose hits are replaced by a hit on a primitive, leave the
    radiance of every lane as it is without the replacement."""
    scene = tpresets.showcase_scene(grid=2, with_meshes=False)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cam = tcam.make_camera(image_width=16, image_height=8, vfov=30.0,
                           lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    n = 128
    pix = torch.arange(n)
    lr = trng.lane_rng(trng.seed_from_int(2), pix, 0)
    o, d = tcam.generate_rays(cam, lr.with_ctx(0, 0), pix, 16)
    retired = pix >= n // 2
    o = torch.where(retired[:, None], torch.tensor([np.inf, 0.0, 1.0]), o)
    d[retired.nonzero()[::2, 0]] = torch.tensor([np.nan, 1.0, 0.0])
    tables = tis.hit_tables(scene)
    kw = dict(tables=tables, max_bounces=3, env_mode=tenv.PHYSICAL_SUN,
              active=~retired)
    want = integrator.trace(scene, env, o, d, lr, **kw)

    real, replaced = tis.intersect, []

    def hit_retired(scene, o, d, tmin, tables):
        hit = real(scene, o, d, tmin, tables)
        bad = ~torch.isfinite(o).all(1) | ~torch.isfinite(d).all(1)
        replaced.append(int(bad.sum()))
        one = torch.ones_like(hit.t)
        return tis.Hit(t=torch.where(bad, one, hit.t),
                       prim_type=torch.where(bad, 1, hit.prim_type),
                       prim_idx=torch.where(bad, 0, hit.prim_idx),
                       hit=hit.hit | bad)

    monkeypatch.setattr(tis, "intersect", hit_retired)
    got = integrator.trace(scene, env, o, d, lr, **kw)
    assert replaced and all(k == n // 2 for k in replaced), replaced
    assert torch.equal(got, want)
    assert not got[retired].any() and got[~retired].any()
