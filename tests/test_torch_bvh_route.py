"""The fused pool's closest hit over a BVH (ops/closest_hit.py
`bvh_closest_hit`, csrc/bvh_hit.cu on the card): from BVH_MIN_PRIMS
primitives on, the pool's tables carry the scene's tree, built once per
scene, and K1's entry walks it; below the threshold nothing changes. On the
CPU the walk is the plain threaded traversal (ops/traverse.py), held here
against K1's plain scan under the budgets of `smoke.stage_hit_agree`; the
kernel's records and its order are held here through a Python twin of its
loop, and the kernel itself against K1's tile scan on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.core.constants import T_MAX
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


def _funnel(n_spheres):
    """A small funnel (n_spheres, one torus), its pool tables (the tree
    attached), and two ray sets as [6, N] rows: random rays from the funnel
    camera's eye, and one diffuse-or-specular bounce of the camera rays at
    their first hits."""
    scene = presets.bvh_stress_scene(n_spheres=n_spheres, mesh_detail=1,
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


@pytest.fixture(scope="module")
def funnel():
    """The funnel at 512 spheres: 8,963 primitives, past BVH_MIN_PRIMS."""
    return _funnel(512)


@pytest.fixture(scope="module")
def funnel300():
    """The funnel at 300 spheres: 8,751 primitives, past BVH_MIN_PRIMS."""
    return _funnel(300)


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


def _ints(col: torch.Tensor) -> torch.Tensor:
    return col.contiguous().view(torch.int32)


def test_records_hold_the_tree():
    """The ordered walk's records decode to the tree: record r is the r-th
    inner node in depth-first order, and holds its left child (node i + 1)
    and right child (escape[i + 1]) as their boxes widened by the node pad
    and their references, a record for an inner child and ~(first slot <<
    LEAF_SHIFT | count) for a leaf; each slot's type and row; a tree of one
    leaf gets one record beside an empty leaf. Past the stack's depth, and
    past LEAF_MAX slots in a leaf, the records refuse the tree."""
    scene = presets.bvh_stress_scene(n_spheres=300, mesh_detail=0)
    tree = scene.bvh
    nodes, slots = tbvh.kernel_records(tree)
    inner = torch.nonzero(tree.count == 0)[:, 0]
    assert nodes.shape == (len(inner), 16) and nodes.dtype == torch.float32
    assert inner[0] == 0
    record_of = {int(i): r for r, i in enumerate(inner.tolist())}
    lo, hi = tree.node_min, tree.node_max
    leaves = 0
    for r, i in enumerate(inner.tolist()):
        left, right = i + 1, int(tree.escape[i + 1])
        assert int(tree.node_level[left]) == int(tree.node_level[right]) \
            == int(tree.node_level[i]) + 1
        for child, (lo_col, ref_col) in ((left, (0, 3)), (right, (8, 7))):
            box_lo = nodes[r, lo_col:lo_col + 3]
            box_hi = nodes[r, lo_col + 4:lo_col + 7]
            assert bool((box_lo < lo[child]).all())
            assert bool((box_hi > hi[child]).all())
            ref = int(_ints(nodes[:, ref_col])[r])
            if int(tree.count[child]) == 0:
                assert ref == record_of[child]
            else:
                leaves += 1
                word = ~ref
                assert word >> tbvh.LEAF_SHIFT == int(tree.first[child])
                assert word & tbvh.LEAF_MAX == int(tree.count[child])
        assert float(nodes[r, 11]) == 0.0 and float(nodes[r, 15]) == 0.0
    assert leaves == int((tree.count > 0).sum())
    assert torch.equal(slots & 3, tree.prim_type)
    assert torch.equal(slots >> 2, tree.prim_row)

    leaf = tree.count > 0
    one = tbvh.build_bvh(presets.bvh_stress_scene(n_spheres=1, mesh_detail=0))
    assert one.node_count == 1
    rec, _ = tbvh.kernel_records(one)
    assert rec.shape == (1, 16)
    assert int(_ints(rec[:, 3])[0]) == ~int(one.count[0])
    assert int(_ints(rec[:, 7])[0]) == ~0

    deep = tree._replace(n_levels=tbvh.STACK_MAX + 2)
    with pytest.raises(ValueError, match="stack holds"):
        tbvh.kernel_records(deep)
    tbvh.kernel_records(tree._replace(n_levels=tbvh.STACK_MAX + 1))
    big = tree._replace(count=torch.where(leaf, tbvh.LEAF_MAX + 1, 0))
    with pytest.raises(ValueError, match="records hold"):
        tbvh.kernel_records(big)


def test_the_card_tree_has_leaves_of_its_own_size(monkeypatch):
    """The leaf size is decided in one place, `leaf_size_on`: HIT_LEAF_SIZE
    on the card, build_bvh's default DEFAULT_LEAF_SIZE (16) off it. On the
    CPU `hit_bvh` takes a scene's own leaf-16 tree and builds one at 16 for
    a scene without; where the device wants HIT_LEAF_SIZE it builds a tree
    of that leaf size in place of the scene's leaf-16 tree (so a scene
    loaded or built with its tree gets the card's tree), and takes a tree
    whose leaves are already that small."""
    import inspect

    assert tbvh.DEFAULT_LEAF_SIZE == 16
    assert inspect.signature(tbvh.build_bvh).parameters[
        "leaf_size"].default == tbvh.DEFAULT_LEAF_SIZE
    assert 1 <= tbvh.HIT_LEAF_SIZE < tbvh.DEFAULT_LEAF_SIZE
    assert tbvh.leaf_size_on("cuda") == tbvh.HIT_LEAF_SIZE
    assert tbvh.leaf_size_on(torch.device("cuda", 1)) == tbvh.HIT_LEAF_SIZE
    assert tbvh.leaf_size_on("cpu") == tbvh.DEFAULT_LEAF_SIZE

    own = presets.bvh_stress_scene(n_spheres=300, mesh_detail=1)
    plain = own.bvh
    assert tbvh.HIT_LEAF_SIZE < plain.leaf_size <= tbvh.DEFAULT_LEAF_SIZE
    assert tbvh.hit_bvh(own).tree is plain
    bare = tbvh.hit_bvh(own._replace(bvh=None)).tree
    assert torch.equal(bare.escape, plain.escape)

    monkeypatch.setattr(tbvh, "leaf_size_on", lambda device:
                        tbvh.HIT_LEAF_SIZE)
    builds = tbvh.hit_bvh.builds
    got = tbvh.hit_bvh(own)
    assert tbvh.hit_bvh.builds == builds + 1 and got.build_ms > 0.0
    card = got.tree
    assert int(card.count.max()) == card.leaf_size <= tbvh.HIT_LEAF_SIZE
    same = tbvh.build_bvh(own, leaf_size=tbvh.HIT_LEAF_SIZE)
    assert torch.equal(card.escape, same.escape)
    assert torch.equal(card.prim_row, same.prim_row)
    assert card.node_count > plain.node_count
    assert tbvh.hit_bvh(own._replace(bvh=same)).tree is same
    assert tbvh.hit_bvh.builds == builds + 1


_F32 = np.float32
_T_MAX_F = float(_F32(1e30))
_DONE = -(1 << 31)


def _plain_t(od, tmin, tables):
    """Each primitive's t on each ray by K1's plain arithmetic: the chunks,
    dots and epilogues of closest_hit_feats_plain with no running best
    (tmax T_MAX), so a primitive's t does not depend on what came before;
    one f32[P, count] per type."""
    feats = intersect.ray_features((od[0], od[1], od[2]),
                                   (od[3], od[4], od[5]))
    p = feats.shape[0]
    a = feats[:, 12:13]
    featsk = intersect.splitk_feats(feats)
    lo = torch.full((p, 1), tmin, dtype=torch.float32)
    hi = torch.full((p, 1), T_MAX, dtype=torch.float32)
    epilogues = (
        lambda h, c, l, u: intersect.sphere_candidate_t_mm(h, c, a, l, u),
        intersect.triangle_candidate_t_mm,
        intersect.box_candidate_t_mm,
    )
    out = []
    for coeff, n_rows, epi in zip(tables.coeffs, tables.counts, epilogues):
        g = coeff.shape[1]
        cols = [torch.zeros((p, 0))]
        for c0 in range(0, n_rows, k1.CHUNK_PRIMS):
            w = min(k1.CHUNK_PRIMS, n_rows - c0)
            block = coeff[:, :, c0:c0 + w].reshape(16, g * w)
            y = intersect.splitk_dot(featsk, intersect.splitk_pack_coeff(block))
            cols.append(epi(*(y[:, i * w:(i + 1) * w] for i in range(g)),
                            lo, hi))
        out.append(torch.cat(cols, dim=1).numpy())
    return out


def _twin_walk(rec, slots, o, d, tmin, t_of):
    """csrc/bvh_hit.cu's ordered walk of one ray, in Python: the slab tests
    of both children in f32 as the kernel computes them, the nearer child
    first and the other pushed with its entry t, a pop dropping entries
    whose entry t exceeds the best t (one at exactly the best t is kept),
    the sentinel under the stack; each leaf slot's t from t_of(type, row)
    under K1's tie rule. Returns ((t, idx, type), counts: records visited,
    pushes, pops culled, slots tested, deepest stack)."""
    inv = _F32(1) / np.where(np.abs(d) < _F32(1e-20),
                             np.where(d < 0, _F32(-1e-20), _F32(1e-20)), d)
    tmin = _F32(tmin)

    def slab(lo, hi):
        x0, x1 = (lo - o) * inv, (hi - o) * inv
        mn, mx = np.fmin(x0, x1), np.fmax(x0, x1)
        tn = np.fmax(np.fmax(mn[:, 0], mn[:, 1]), np.fmax(mn[:, 2], tmin))
        tf = np.fmin(np.fmin(mx[:, 0], mx[:, 1]), mx[:, 2])
        return tn.tolist(), tf.tolist()

    tnl, tfl = slab(rec[:, 0:3], rec[:, 4:7])
    tnr, tfr = slab(rec[:, 8:11], rec[:, 12:15])
    lref = rec[:, 3].copy().view(np.int32).tolist()
    rref = rec[:, 7].copy().view(np.int32).tolist()
    best, bidx, btype = _T_MAX_F, 0, 0
    counts = [0, 0, 0, 0, 0]
    stack = [(_DONE, -np.inf)]

    def pop():
        while stack[-1][1] > best:
            stack.pop()
            counts[2] += 1
        return stack.pop()[0]

    ref = 0
    while ref != _DONE:
        while ref >= 0:
            counts[0] += 1
            hl = tnl[ref] <= min(tfl[ref], best)
            hr = tnr[ref] <= min(tfr[ref], best)
            if hl and hr:
                right_first = tnr[ref] < tnl[ref]
                stack.append((lref[ref], tnl[ref]) if right_first
                             else (rref[ref], tnr[ref]))
                ref = rref[ref] if right_first else lref[ref]
                counts[1] += 1
                counts[4] = max(counts[4], len(stack) - 1)
            elif hl or hr:
                ref = lref[ref] if hl else rref[ref]
            else:
                ref = pop()
        if ref == _DONE:
            break
        word = ~ref
        first = word >> tbvh.LEAF_SHIFT
        for s in range(first, first + (word & tbvh.LEAF_MAX)):
            ptype, row = slots[s] & 3, slots[s] >> 2
            t = t_of(ptype, row)
            tie = (t == best and t < _T_MAX_F
                   and (ptype, row) < (btype, bidx))
            if t < best or tie:
                best, bidx, btype = t, row, ptype
            counts[3] += 1
        ref = pop()
    return (best, bidx, btype), counts


@pytest.mark.parametrize("rays", ["random", "bounce"])
def test_the_ordered_walk_over_the_records_is_k1s_answer(funnel300, rays):
    """A Python twin of the kernel's loop over the card tree's records
    (near child first, the stack, pops culled by best t with `<=` kept)
    gives closest_hit_plain's (t, idx, type) on every lane of the funnel
    at 300 spheres, ties included, each slot's t taken from the plain
    arithmetic; the order and the culls are exercised (pushes, culled
    pops), the stack stays within STACK_MAX, and a ray visits fewer
    records than the tree holds."""
    scene, tables, sets = funnel300
    od = sets[rays]
    n = od.shape[1]
    rec, slots = tbvh.kernel_records(
        tbvh.build_bvh(scene, leaf_size=tbvh.leaf_size_on("cuda")))
    rec, slots = rec.numpy(), slots.tolist()
    tp, ip, yp = k1.closest_hit_plain(od, 1e-3, tables.coeffs, tables.counts)
    tmat = _plain_t(od, 1e-3, tables)
    o = od[:3].T.numpy()
    d = od[3:].T.numpy()
    got, total = [], np.zeros(5, np.int64)
    for j in range(n):
        row_t = [m[j] for m in tmat]
        hit, counts = _twin_walk(rec, slots, o[j], d[j], 1e-3,
                                 lambda ptype, row: float(row_t[ptype][row]))
        got.append(hit)
        total[:4] += counts[:4]
        total[4] = max(total[4], counts[4])
    t = torch.tensor([g[0] for g in got], dtype=torch.float32)
    idx = torch.tensor([g[1] for g in got], dtype=torch.int32)
    typ = torch.tensor([g[2] for g in got], dtype=torch.int32)
    assert int((tp < 1e30).sum()) > n // 8
    assert torch.equal(t, tp)
    assert torch.equal(idx, ip) and torch.equal(typ, yp)
    visits, pushes, culled, tested, deepest = total.tolist()
    assert pushes > 0 and culled > 0 and tested > 0
    assert deepest <= tbvh.STACK_MAX
    assert visits < rec.shape[0] * n


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
