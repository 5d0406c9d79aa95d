"""The port's kernel probes (raytracer_project_tpu_torch/tools) against the
reference's probe kernels (tools/probe_*.py) on the CPU.

The reference probes cannot be imported: probe_a1_ablate runs at import,
and the other kernels are nested in `main`. So each kernel's FunctionDef
is taken from the probe's source with `ast`, executed in a namespace that
binds the module's names and `main`'s parameters, and run through
`pl.pallas_call(..., interpret=True)` with the probe's own specs. The
reference's d0-d2 decode variants no longer trace (they index a [B, 28]
fetch that is now [28, B]); they are held against the JAX package's
record decoders applied to rows of its packed tables.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_project_tpu.core import vecmath as jvecmath
from raytracer_project_tpu.core.constants import T_MAX
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import fused_step as jfs
from raytracer_project_tpu.ops import intersect as jisect
from raytracer_project_tpu.ops import pallas_intersect as pi
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import intersect as tisect
from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
from raytracer_project_tpu_torch.tools import probe_decode as pd
from raytracer_project_tpu_torch.tools import probe_onehot as po

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


def _defs(path: Path, *names, scope: str | None = None):
    """The FunctionDefs `names` of the probe at `path`: at module level, or
    anywhere inside the function `scope` (first match of each name, or the
    `If` branch given as name "kernel@body" / "kernel@orelse")."""
    tree = ast.parse(path.read_text())
    if scope is not None:
        tree = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == scope)
    out = []
    for name in names:
        name, _, branch = name.partition("@")
        nodes = tree.body
        if branch:
            nodes = getattr(next(n for n in tree.body if isinstance(n, ast.If)),
                            branch)
        out.append(next(n for n in nodes
                        if isinstance(n, ast.FunctionDef) and n.name == name))
    return ast.Module(body=out, type_ignores=[])


def _exec(path: Path, module: ast.Module, **names) -> dict:
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools,
              **names)
    exec(compile(module, str(path), "exec"), ns)
    return ns


# --- P1: the closest-hit ablation ------------------------------------------

@pytest.fixture(scope="module")
def p1():
    """The showcase scene in both packages and 1,024 rays o = 3 N(0, 1),
    d = N(0, 1) made with numpy from a seed (the probe's distributions)."""
    js = jpresets.showcase_scene(with_bvh=False)
    ts = tpresets.showcase_scene()
    r = np.random.default_rng(0)
    od = np.concatenate([3.0 * r.normal(size=(3, 1024)),
                         r.normal(size=(3, 1024))]).astype(np.float32)
    return js, ts, od


def _reference_ablate(js, od, variant):
    """tools/probe_a1_ablate.py's kernel for `variant`, with run()'s specs
    (probe_a1_ablate.py:112-138), in interpret mode."""
    path = TOOLS / "probe_a1_ablate.py"
    ns = _exec(path, _defs(path, "make_kernel"), T_MAX=T_MAX, pi=pi,
               RAY_FEATURE_DIM=16, CHUNK=pi.CHUNK_PRIMS, B=pi.BLOCK_RAYS,
               scene=js)
    kernel = ns["make_kernel"](variant)
    mm = js.mm
    sb, tb, bb = (pi._coarsen_bounds(b) for b in
                  (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds))
    p, b = od.shape[1], pi.BLOCK_RAYS
    out = pl.pallas_call(
        kernel, grid=(p // b,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec((6, b), lambda i: (0, i),
                               memory_space=pltpu.VMEM)]
        + [pl.BlockSpec(x.shape, lambda i: (0, 0, 0), memory_space=pltpu.VMEM)
           for x in (mm.sphere_coeff, mm.tri_coeff, mm.box_coeff)]
        + [pl.BlockSpec(x.shape, lambda i: (0, 0), memory_space=pltpu.SMEM)
           for x in (sb, tb, bb)],
        out_specs=tuple(pl.BlockSpec((b, 1), lambda i: (i, 0),
                                     memory_space=pltpu.VMEM)
                        for _ in range(3)),
        out_shape=(jax.ShapeDtypeStruct((p, 1), jnp.float32),
                   jax.ShapeDtypeStruct((p, 1), jnp.int32),
                   jax.ShapeDtypeStruct((p, 1), jnp.int32)),
        interpret=True,
    )(jnp.zeros((1, 1), jnp.float32), jnp.asarray(od), mm.sphere_coeff,
      mm.tri_coeff, mm.box_coeff, sb, tb, bb)
    for x in out[1:]:
        assert not np.asarray(x).any()
    return np.asarray(out[0])[:, 0]


def _port_ablate(ts, od, variant):
    """The port's plain P1 as the probe runs it: every padded column
    scanned, the cull per 512-ray block."""
    coeffs, bounds, _ = pa.scene_tables(ts)
    cols = tuple(c.shape[2] for c in coeffs)
    t, idx, typ = pa.ablate_plain(torch.as_tensor(od), 0.0, coeffs, bounds,
                                  cols, variant, pa.BLOCK)
    assert not idx.any() and not typ.any()
    return t.numpy()


@pytest.mark.parametrize("variant", pa.VARIANTS)
def test_ablation_matches_reference_probe(p1, variant):
    """full/nocull: the miss sets agree but on <= 1% of lanes, >= 97% of
    the common hits within 5e-3 relative and none over 5e-2 (the two sides
    sum the 16-term dots in another order); nodots: T_MAX everywhere;
    cheapepi (the minimum raw dot, a cull-dependent value): <= 0.5% of
    lanes off by more than 1e-4 relative."""
    js, ts, od = p1
    ref = _reference_ablate(js, od, variant)
    out = _port_ablate(ts, od, variant)
    n = od.shape[1]
    if variant == "nodots":
        assert (ref == np.float32(T_MAX)).all() and (out == ref).all()
        return
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
    if variant == "cheapepi":
        assert (ref < T_MAX).all()
        assert (rel > 1e-4).sum() <= n // 200, np.sort(rel)[-8:]
        return
    hr, ho = ref < T_MAX, out < T_MAX
    assert hr.mean() > 0.5
    assert (hr != ho).sum() <= n // 100
    both = hr & ho
    assert (rel[both] <= 5e-3).mean() >= 0.97
    assert rel[both].max() <= 5e-2


def test_ablation_cull_changes_no_result(p1):
    """The port's full and nocull scans give the same t bit for bit, both
    at the card's grouping (K1's ScanTables: 128-wide tiles, warps of 32)
    and with the probe's padded columns, 512-wide chunks and 512-ray
    blocks."""
    _, ts, od = p1
    scan = k1.scan_tables(ts)
    coeffs, bounds, _ = pa.scene_tables(ts)
    odt = torch.as_tensor(od)
    for tab, block in (((scan.coeffs, scan.bounds, scan.counts), pa.WARP),
                       ((coeffs, bounds, tuple(c.shape[2] for c in coeffs)),
                        pa.BLOCK)):
        full = pa.ablate_plain(odt, 0.0, *tab, "full", block)
        nocull = pa.ablate_plain(odt, 0.0, *tab, "nocull", block)
        assert torch.equal(full[0], nocull[0])
        if block == pa.WARP:
            card = full[0]
    # On CPU tensors the wrapper is the plain version at the card's
    # grouping; its full t is K1's (whose plain version sums the dots as
    # the reference's digit split does) under the closest-hit budgets.
    t = pa.ablate(odt, 0.0, scan, "full")[0]
    assert torch.equal(t, card)
    tk = k1.closest_hit_plain(odt, 0.0, scan.coeffs, scan.counts)[0]
    both = (tk < T_MAX) & (t < T_MAX)
    assert int(((tk < T_MAX) != (t < T_MAX)).sum()) <= t.shape[0] // 100
    rel = (t - tk).abs()[both] / tk.abs()[both].clamp(min=1e-3)
    assert float((rel > 5e-3).float().mean()) <= 0.03


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ablation_cull_only_skips_tiles(p1, seed):
    """At the card's grouping a cull only skips tiles: cheapepi's t is
    never below the unculled minimum of the raw group-0 dots over every
    primitive, and is one of those dots; nodots is T_MAX on every lane.
    Rays o = s N(0, 1), d = N(0, 1) with the scale s from the seed."""
    _, ts, _ = p1
    scan = k1.scan_tables(ts)
    r = np.random.default_rng(seed)
    od = torch.as_tensor(np.concatenate([
        (1.0 + 3.0 * seed) * r.normal(size=(3, 1024)),
        r.normal(size=(3, 1024))]).astype(np.float32))
    feats = tisect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    # Every raw group-0 dot, tile by tile as the plain version forms them.
    dots = []
    for coeff, n in zip(scan.coeffs, scan.counts):
        g = coeff.shape[1]
        for c0 in range(0, n, k1.SCAN_TILE):
            w = min(k1.SCAN_TILE, n - c0)
            dots.append((feats @ coeff[:, :, c0:c0 + w].reshape(16, g * w))
                        [:, :w])
    dots = torch.cat(dots, 1)
    t = pa.ablate(od, 0.0, scan, "cheapepi")[0]
    assert bool((t >= dots.amin(1)).all())
    assert bool((dots == t[:, None]).any(1).all())
    assert bool((t > dots.amin(1)).any())      # the cull did skip tiles
    assert bool((pa.ablate(od, 0.0, scan, "nodots")[0] == T_MAX).all())


def test_ablation_wrappers_on_the_cpu(p1, capsys):
    """The probe's entry runs the four variants on the CPU, and an unknown
    variant raises."""
    _, ts, od = p1
    odt = torch.as_tensor(od[:, :256]).contiguous()
    runs = pa.main("cpu", p=256)
    assert list(runs) == list(pa.VARIANTS)
    assert torch.equal(runs["full"]["t"], runs["nocull"]["t"])
    assert "nocull" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown variant"):
        pa.ablate(odt, 0.0, k1.scan_tables(ts), "nothing")


# --- P2 and P4: the one-hot row fetch ---------------------------------------

P_ONEHOT, D_ONEHOT, N_ROWS, N_OUT = 4096, 2048, 1536, 24
# (probe, mode, window, n_out); the cases at N_OUT keep their first ids.
# The others hold the fetch where the kernel's unrolled output loop and
# its k % 28 wrap matter: one output, past the 28 columns, MAX_OUT.
ONEHOT_CASES = [pytest.param(*c, N_OUT, id="-".join(map(str, c))) for c in (
    [("P2", "col", 300), ("P2", "col", 2048)]
    + [("P4", mode, 512) for mode in po.MODES])] + [
    pytest.param(probe, mode, 512, n, id=f"{probe}-{mode}-512-n{n}")
    for probe, mode in (("P2", "col"), ("P4", "tdot")) for n in (1, 29, 32)]


def _reference_onehot(probe, mode, window, n_out, t, idx, table):
    """The reference probe's kernel (tools/probe_onehot.py:22 for P2,
    tools/probe_onehot2.py:52/:71 for P4) with its main()'s specs."""
    lane = pl.BlockSpec((D_ONEHOT,), lambda i: (i,), memory_space=pltpu.VMEM)
    flat = lambda: (tuple([lane] * n_out), tuple(
        jax.ShapeDtypeStruct((P_ONEHOT,), jnp.float32) for _ in range(n_out)))
    if probe == "P2":
        path = TOOLS / "probe_onehot.py"
        ns = _exec(path, _defs(path, "kernel", scope="main"), n_rows=N_ROWS,
                   window=window, cols=28)
        out_specs, out_shape = flat()
    else:
        path = TOOLS / "probe_onehot2.py"
        branch = ("body" if mode in ("plain", "col", "tdotflat") else "orelse")
        ns = _exec(path, _defs(path, "onehot_grow", "onehot_grow_t",
                               f"kernel@{branch}", scope="main"),
                   mode=mode, n_out=n_out, n_rows=N_ROWS, window=window,
                   cols=28)
        if branch == "body":
            out_specs, out_shape = flat()
        else:
            out_specs = pl.BlockSpec((n_out, D_ONEHOT), lambda i: (0, i),
                                     memory_space=pltpu.VMEM)
            out_shape = jax.ShapeDtypeStruct((n_out, P_ONEHOT), jnp.float32)
    full = pl.BlockSpec(table.shape, lambda i: (0, 0), memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        ns["kernel"], grid=(P_ONEHOT // D_ONEHOT,),
        in_specs=[lane, lane, full], out_specs=out_specs,
        out_shape=out_shape, interpret=True,
    )(jnp.asarray(t), jnp.asarray(idx), jnp.asarray(table))
    return np.stack([np.asarray(x) for x in out]) if isinstance(
        out, (tuple, list)) else np.asarray(out)


@pytest.mark.parametrize("probe,mode,window,n_out", ONEHOT_CASES)
def test_onehot_fetch_matches_reference_probe(probe, mode, window, n_out):
    """A random table and random indices in [-2, n_rows + 2), some outside
    the table: every output equal, bit for bit."""
    r = np.random.default_rng(5)
    t = r.normal(size=P_ONEHOT).astype(np.float32)
    idx = r.uniform(-2, N_ROWS + 2, P_ONEHOT).astype(np.float32)
    table = r.normal(size=(N_ROWS, 28)).astype(np.float32)
    if po.MODES[mode][1]:
        table = np.ascontiguousarray(table.T)
    assert ((idx < 0) | (idx >= N_ROWS)).sum() > 4
    ref = _reference_onehot(probe, mode, window, n_out, t, idx, table)
    out = po.onehot_fetch(torch.as_tensor(t), torch.as_tensor(idx),
                          torch.as_tensor(table), n_out, mode)
    out = out.numpy() if po.MODES[mode][2] else np.stack(
        [x.numpy() for x in out])
    assert out.shape == ref.shape == (n_out, P_ONEHOT)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", tuple(po.MODES))
def test_onehot_fetch_with_no_outputs(mode):
    """n_out 0: an empty [0, p] matrix in the matrix modes, else no
    outputs; a staged fetch of mode plain, which has no table, refused."""
    t, idx, table = po.make_inputs(N_ROWS, 64, po.MODES[mode][1], device="cpu")
    out = po.onehot_fetch(t, idx, table, 0, mode)
    assert (out.shape == (0, 64)) if po.MODES[mode][2] else out == ()
    if mode == "plain":
        with pytest.raises(ValueError, match="stage"):
            po.onehot_fetch(t, idx, table, 24, mode, staged=True)


# --- P3: the decode bisection ----------------------------------------------

@pytest.fixture(scope="module")
def p3():
    """The showcase tables of both packages and the port's plain K1 hits of
    512 camera-like and 512 bounce-like rays (numpy, seeded)."""
    js = jpresets.showcase_scene(with_bvh=False)
    ts = tpresets.showcase_scene()
    jt = jfs.build_tables(js, jenv.make_environment(**ENV_KW),
                          jenv.PHYSICAL_SUN)
    tt = tfs.build_tables(ts, tenv.make_environment(**ENV_KW),
                          tenv.PHYSICAL_SUN)
    r = np.random.default_rng(3)
    m = 512
    o = np.concatenate([np.tile(np.float32([12.0, 2.5, 6.0]), (m, 1)),
                        np.stack([r.uniform(-8, 8, m), r.uniform(0.05, 3, m),
                                  r.uniform(-8, 8, m)], 1)])
    look = np.stack([r.uniform(-4, 4, m), r.uniform(-1, 3, m),
                     r.uniform(-4, 4, m)], 1)
    d = np.concatenate([look - o[:m], r.normal(size=(m, 3))])
    od = torch.as_tensor(np.concatenate([o.T, d.T]).astype(np.float32))
    hit = k1.closest_hit_plain(od, 1e-3, tt.scan.coeffs, tt.scan.counts)
    return js, jt, tt, od, hit


def _f32_table(split):
    """A [3*cols, rows] digit-split table of the reference as f32 [cols,
    rows]: hi + mid + lo, exact."""
    x = np.asarray(split.astype(jnp.float32))
    c = x.shape[0] // 3
    return (x[:c] + x[c:2 * c]) + x[2 * c:]


def _reference_stage(stage, js, jt, od, hit):
    """d0/d1/d2 as the reference probe's kernel writes them
    (tools/probe_decode.py:62-127) on its decode's current [28, B] fetch:
    the JAX package's record decoders on rows of its packed tables."""
    rectab = _f32_table(jt.rectab)
    t, idx, typ = (x.numpy() for x in hit)
    ns, nt = js.spheres.count, js.triangles.count
    is_tri, is_box, is_sph = typ == 1, typ == 2, typ == 0
    base = np.where(is_tri, ns, np.where(is_box, ns + nt, 0))
    grow = rectab[:, np.clip(idx + base, 0, rectab.shape[1] - 1)]
    hitf = (t < T_MAX).astype(np.float32)
    head = [hitf, t]
    if stage == 0:
        return np.stack(head + [grow[k] for k in range(22)])
    o = tuple(jnp.asarray(od[k].numpy()) for k in range(3))
    d = tuple(jnp.asarray(od[3 + k].numpy()) for k in range(3))
    t_safe = jnp.asarray(np.where(t < T_MAX, t, 1.0).astype(np.float32))
    b = t.shape[0]

    def sel_cols(mask, default, ncols):
        return tuple(jnp.asarray(np.where(mask, grow[k], np.float32(default[k])))
                     if k < ncols else jnp.zeros((b,), jnp.float32)
                     for k in range(jisect._PACK_COLS))

    def widen(parts):
        parts = list(parts)
        parts[4] = parts[4].astype(jnp.float32)
        return parts

    def sel(mask, a, bb):
        if isinstance(a, tuple):
            return tuple(jnp.where(mask, y, x) for x, y in zip(a, bb))
        return jnp.where(mask, bb, a)

    sp = widen(jisect._sphere_record_soa(
        sel_cols(is_sph, jisect._SPHERE_DEFAULT_ROW, 5), o, d, t_safe,
        acos_fn=jvecmath.acos_poly, atan2_fn=jvecmath.atan2_poly))
    tp = widen(jisect._triangle_record_soa(
        sel_cols(is_tri, jisect._TRI_DEFAULT_ROW, 28), o, d, t_safe))
    parts = tuple(sel(jnp.asarray(is_tri), sp[i], tp[i]) for i in range(8))
    bp = widen(jisect._box_record_soa(
        sel_cols(is_box, jisect._BOX_DEFAULT_ROW, 13), o, d, t_safe))
    parts = tuple(sel(jnp.asarray(is_box), parts[i], bp[i]) for i in range(8))
    _, normal, tangent, bitangent, front, u, v, mat = (
        tuple(np.asarray(c) for c in x) if isinstance(x, tuple)
        else np.asarray(x) for x in parts)
    rows = head + [*normal, *tangent, *bitangent, front, u, v,
                   mat.astype(np.float32)]
    if stage == 1:
        return np.stack(rows + [grow[k] for k in range(9)])
    mattab, texmeta = _f32_table(jt.mattab), _f32_table(jt.texmeta)
    mrow = mattab[:, np.clip(mat, 0, mattab.shape[1] - 1).astype(np.int32)]
    tex_id = mrow[5]
    tmeta = texmeta[:, np.clip(tex_id, 0, texmeta.shape[1] - 1).astype(np.int32)]
    return np.stack(rows + [mrow[0], mrow[3], mrow[4], tmeta[0], tmeta[1],
                            tmeta[2], tmeta[3], tex_id, mrow[6]])


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_decode_stage_matches_reference(p3, stage):
    """Flags, t, the material id and every fetched column equal exactly;
    the decoded normal, tangent, bitangent and uv within 1e-6 (abs + rel).
    d3 is K2, held in tests/test_torch_fused_step.py."""
    js, jt, tt, od, hit = p3
    assert float((hit[0] < T_MAX).float().mean()) > 0.5
    ref = _reference_stage(stage, js, jt, od, hit)
    out = pd.decode_stage(stage, tt, od, *hit).numpy()
    assert out.shape == ref.shape == (tfs._RO_ROWS, od.shape[1])
    float_rows = () if stage == 0 else tuple(range(2, 11)) + (12, 13)
    for k in range(out.shape[0]):
        if k in float_rows:
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"row {k}")
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=f"row {k}")


def test_decode_stage_refuses_stage_3(p3):
    """P3's stages are 0, 1 and 2 (d3 is K2): stage 3 raises."""
    _, _, tt, od, hit = p3
    with pytest.raises(ValueError, match="stage 3"):
        pd.decode_stage(3, tt, od, *hit)


def test_every_c_entry_matches_its_signature():
    """Each entry of kernels.SIGNATURES has as many argument types as its
    extern "C" function in csrc/<source>.cu has parameters (the stream
    last), each a pointer where the C side takes one: a missing type makes
    ctypes pass a pointer as a 32-bit int."""
    import ctypes
    import re

    from raytracer_project_tpu_torch import kernels

    for entry, (source, argtypes) in kernels.SIGNATURES.items():
        assert source in kernels.SOURCES, entry
        text = (kernels._CSRC / f"{source}.cu").read_text()
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert m, entry
        params = [x.strip() for x in m.group(1).split(",")]
        assert len(params) == len(argtypes), entry
        assert params[-1] == "void* stream", entry
        for param, ty in zip(params, argtypes):
            assert ("*" in param) == (ty is ctypes.c_void_p), (entry, param)
