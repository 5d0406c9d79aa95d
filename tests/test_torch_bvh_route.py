"""The fused pool's closest hit over a BVH (ops/closest_hit.py
`bvh_closest_hit`, csrc/bvh_hit.cu on the card): from BVH_MIN_PRIMS
primitives on, the pool's tables carry the scene's tree, built once per
scene, and K1's entry walks it; below the threshold nothing changes. On the
CPU the walk is the plain threaded traversal (ops/traverse.py), held here
against K1's plain scan under the budgets of `smoke.stage_hit_agree`; the
kernel itself is held against K1's tile scan on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.ops import bvh as tbvh
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator, intersect, shade
from raytracer_project_tpu_torch.utils import spans

torch.set_num_threads(2)

FUNNEL_CAM = dict(vfov=35.0, lookfrom=(5.0, 6.0, 6.0), lookat=(5.0, 4.0, -12.0))
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
N_RAYS = 1024


def _calls(monkeypatch) -> dict:
    """Counts the calls of K1's two plain versions, the scan
    (`closest_hit_plain`) and the BVH walk (`bvh_closest_hit_plain`), by
    name; on CPU tensors nothing launches, so the launch counts stay."""
    calls = {"closest_hit_plain": 0, "bvh_closest_hit_plain": 0}
    for name in calls:
        def spy(*args, _fn=getattr(k1, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(k1, name, spy)
    return calls


@pytest.fixture(scope="module")
def funnel():
    """A small funnel (514 spheres, one torus: 8,963 primitives, past
    BVH_MIN_PRIMS), its pool tables, and two ray sets as [6, N] rows:
    random rays from the funnel camera's eye, and one diffuse-or-specular
    bounce of the camera rays at their first hits."""
    scene = presets.bvh_stress_scene(n_spheres=512, mesh_detail=1,
                                     with_bvh=False)
    assert scene.primitive_count >= intersect.BVH_MIN_PRIMS
    tables = tfs.build_tables(scene, tenv.make_environment(**ENV_KW),
                              tenv.PHYSICAL_SUN).scan
    r = np.random.default_rng(3)
    o = np.tile(np.float32(FUNNEL_CAM["lookfrom"]), (N_RAYS, 1))
    d = np.stack([r.uniform(-0.4, 0.4, N_RAYS), r.uniform(-0.5, 0.2, N_RAYS),
                  -np.ones(N_RAYS)], 1).astype(np.float32)
    random = torch.as_tensor(np.concatenate([o.T, d.T])).contiguous()

    w, h = 32, N_RAYS // 32
    cam = tcam.make_camera(image_width=w, image_height=h, **FUNNEL_CAM)
    pix = torch.arange(w * h)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, w)
    t, idx, typ = k1.closest_hit_plain(torch.cat([o.T, d.T]).contiguous(),
                                       1e-3, tables.coeffs, tables.counts)
    first = intersect.Hit(t=t, prim_type=typ, prim_idx=idx, hit=t < 1e30)
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    keep = first.hit[:, None]
    bounce = torch.cat([torch.where(keep, sc.origin, o).T,
                        torch.where(keep, sc.direction, d).T]).contiguous()
    return scene, tables, {"random": random, "bounce": bounce}


def _tables(scene):
    return tfs.build_tables(scene, tenv.make_environment(**ENV_KW),
                            tenv.PHYSICAL_SUN)


@pytest.mark.parametrize("offset, carries", [(-1, True), (0, True),
                                             (1, False)])
def test_tables_carry_a_bvh_from_the_threshold_on(monkeypatch, offset,
                                                  carries):
    """The pool's tables carry the tree exactly when the scene has
    BVH_MIN_PRIMS primitives or more, with its node count, depth and build
    milliseconds; without a tree K1's tables are as they were."""
    scene = presets.bvh_stress_scene(n_spheres=64, with_bvh=False)
    n = scene.primitive_count
    monkeypatch.setattr(intersect, "BVH_MIN_PRIMS", n + offset)
    scan = _tables(scene).scan
    assert (scan.bvh is not None) == carries
    plain = k1.scan_tables(scene)
    for a, b in zip(scan.rows + scan.bounds, plain.rows + plain.bounds):
        assert torch.equal(a, b)
    if carries:
        tree = tbvh.build_bvh(scene)
        assert scan.bvh.node_count == tree.node_count > 1
        assert scan.bvh.depth == tree.n_levels > 1
        assert scan.bvh.build_ms > 0.0
        assert torch.equal(scan.bvh.tree.escape, tree.escape)


def test_the_scenes_own_tree_is_taken_and_a_build_is_a_span(monkeypatch):
    """A scene built with its BVH hands that tree over (no build, 0 ms);
    one built without gets a build, inside the span `bvh.build` under
    `tables.build`, counted on `hit_bvh.builds`."""
    from torch.profiler import profile

    monkeypatch.setattr(intersect, "BVH_MIN_PRIMS", 10)
    own = presets.bvh_stress_scene(n_spheres=64)
    builds = tbvh.hit_bvh.builds
    scan = _tables(own).scan
    assert scan.bvh.tree is own.bvh and scan.bvh.build_ms == 0.0
    assert tbvh.hit_bvh.builds == builds
    bare = own._replace(bvh=None)
    with profile() as prof:
        with spans.span("tables.build"):
            _tables(bare)
    assert tbvh.hit_bvh.builds == builds + 1
    events = {e.name: e for e in prof.events()}
    outer, inner = events["tables.build"], events["bvh.build"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_records_hold_the_tree():
    """The kernel's node records and slots decode to the tree: its boxes
    (widened by the node pad), escapes, and each leaf's first slot and
    count; each slot's type and row."""
    scene = presets.bvh_stress_scene(n_spheres=300, mesh_detail=0)
    tree = scene.bvh
    nodes, slots = tbvh.kernel_records(tree)
    assert nodes.shape == (tree.node_count, 8) and nodes.dtype == torch.float32
    bits = lambda col: nodes[:, col].contiguous().view(torch.int32)
    assert torch.equal(bits(3), tree.escape)
    word = bits(7)
    leaf = tree.count > 0
    assert torch.equal(word == 0, ~leaf)
    assert torch.equal(word[leaf] >> tbvh.LEAF_SHIFT, tree.first[leaf])
    assert torch.equal(word[leaf] & tbvh.LEAF_MAX, tree.count[leaf])
    assert bool((nodes[:, :3] < tree.node_min).all())
    assert bool((nodes[:, 4:7] > tree.node_max).all())
    assert torch.equal(slots & 3, tree.prim_type)
    assert torch.equal(slots >> 2, tree.prim_row)
    big = tree._replace(count=torch.where(leaf, tbvh.LEAF_MAX + 1, 0))
    with pytest.raises(ValueError, match="records hold"):
        tbvh.kernel_records(big)


@pytest.mark.parametrize("rays", ["random", "bounce"])
def test_closest_hit_over_the_bvh_matches_k1(funnel, rays, monkeypatch):
    """On CPU tensors K1's entry with a BVH (the plain traversal) against
    K1's plain scan, under smoke.stage_hit_agree's budgets: hit flips <=
    max(2, 1%), winner flips <= max(2, 2.5%), same-winner t at most 3% over
    5e-3 relative and none over 5e-2; the entry takes the BVH walk alone,
    and counts no launch, since none is made."""
    scene, tables, sets = funnel
    od = sets[rays]
    n = od.shape[1]
    launches, bvh_launches = k1.closest_hit.launches, k1.closest_hit.bvh_launches
    calls = _calls(monkeypatch)
    tb, ib, yb = k1.closest_hit(od, 1e-3, tables)
    assert calls == {"closest_hit_plain": 0, "bvh_closest_hit_plain": 1}
    assert k1.closest_hit.launches == launches
    assert k1.closest_hit.bvh_launches == bvh_launches
    tp, ip, yp = k1.closest_hit_plain(od, 1e-3, tables.coeffs, tables.counts)
    hb, hp = tb < 1e30, tp < 1e30
    assert int(hb.sum()) > n // 8
    assert int((hb != hp).sum()) <= max(2, n // 100)
    both = hb & hp
    same = both & (ib == ip) & (yb == yp)
    assert int((both & ~same).sum()) <= max(2, n // 40)
    rel = ((tb - tp).abs() / tp.abs().clamp(min=1e-3))[same]
    assert float((rel > 5e-3).float().mean()) <= 0.03
    assert float(rel.max()) <= 5e-2


def test_fused_render_on_the_bvh_route_agrees_with_k1(monkeypatch):
    """A 32x18 @ 2 spp fused-pool render of a small showcase (spheres,
    boxes, the teapot's triangles) with the threshold lowered under its
    primitive count, against the same render on K1's route: the pool
    budgets (mean |d| <= 0.01, frac(max-channel |d| > 0.05) <= 0.01). The
    tree is built once, on the first pool call, and reused by the next;
    every closest hit of the BVH render goes through the BVH route."""
    scene = presets.showcase_scene(grid=2, with_meshes=True, with_bvh=False)
    cam = tcam.make_camera(image_width=32, image_height=18, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    cfg = integrator.RenderConfig(width=32, height=18, samples_per_pixel=2,
                                  max_depth=6)
    monkeypatch.setattr(tfs, "tables_cache", tfs.DerivedCache())
    calls = _calls(monkeypatch)
    ref = integrator.render(scene, cam, env, 3, cfg, device="cpu")["beauty"]
    assert calls["closest_hit_plain"] > 0
    assert calls["bvh_closest_hit_plain"] == 0

    monkeypatch.setattr(intersect, "BVH_MIN_PRIMS", scene.primitive_count)
    monkeypatch.setattr(tfs, "tables_cache", tfs.DerivedCache())
    builds, launches = tbvh.hit_bvh.builds, k1.closest_hit.launches
    calls.update(closest_hit_plain=0, bvh_closest_hit_plain=0)
    out = integrator.render(scene, cam, env, 3, cfg, device="cpu")["beauty"]
    assert (tfs.tables_cache.built, tbvh.hit_bvh.builds) == (1, builds + 1)
    assert calls["bvh_closest_hit_plain"] > 0
    assert calls["closest_hit_plain"] == 0
    assert k1.closest_hit.launches == launches
    integrator.render(scene, cam, env, 4, cfg, device="cpu")
    assert tfs.tables_cache.built == 1 and tfs.tables_cache.reused >= 1
    assert tbvh.hit_bvh.builds == builds + 1

    a, b = out.numpy(), ref.numpy()
    assert np.isfinite(a).all() and a.max() > 0
    d = np.abs(a - b)
    assert d.mean() <= 0.01, d.mean()
    assert (d.max(axis=-1) > 0.05).mean() <= 0.01
