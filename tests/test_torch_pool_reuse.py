"""What the fused pool derives from its inputs, reused between calls
(ops/fused_step.py `DerivedCache`): the scene's tables, and the camera's
and environment's parameters of K1 and K3, are built once per distinct
input and reused while the same tensors come unchanged. A second call, a
new session over the same scene and the windows of one device reuse; an
in-place edit, a new scene, environment, mode or camera builds anew what
derives from it; windows of different devices build at once; and renders
through reused values equal renders from fresh builds bit for bit.
The pool's start on the card (`initial_state`'s CUDA branch) is checked
here for its C signature only; tests/test_torch_cuda.py runs it."""

import threading
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator
from raytracer_project_tpu_torch.parallel import render as prender
from raytracer_project_tpu_torch.utils.session import RenderSession

torch.set_num_threads(2)

W, H = 16, 9
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
CACHES = ("tables", "params")


def _scene(**kw):
    return presets.showcase_scene(grid=2, with_meshes=False, **kw)


def _cam(**kw):
    return tcam.make_camera(image_width=W, image_height=H, **{**CAM_KW, **kw})


def _env(**kw):
    return tenv.make_environment(**{"sun_direction": (0.4, 0.7, 0.2),
                                    "sun_intensity": 6.0, **kw})


def _cfg(**kw):
    return integrator.RenderConfig(**{"width": W, "height": H,
                                      "samples_per_pixel": 1, "max_depth": 3,
                                      **kw})


def _counts():
    return {name: (getattr(tfs, f"{name}_cache").built,
                   getattr(tfs, f"{name}_cache").reused) for name in CACHES}


def _since(before):
    """{cache: (builds, reuses)} since the counts `before`."""
    now = _counts()
    return {k: (now[k][0] - before[k][0], now[k][1] - before[k][1])
            for k in CACHES}


def _pool(scene, cam, env, cfg, seed=0):
    return tfs.render_pool_fused(scene, cam, env, seed, cfg, 1,
                                 with_stats=True)


def _fresh_caches(monkeypatch):
    for name in CACHES:
        monkeypatch.setattr(tfs, f"{name}_cache", tfs.DerivedCache())


@pytest.mark.parametrize("second", ["pool call", "session"])
def test_a_second_call_reuses(second):
    """A second pool call over the same inputs reuses the tables and the
    parameters; the first update of a second RenderSession over the same
    scene and environment (a new camera, as each frame of a progressive
    viewer has) reuses the tables and builds the parameters."""
    scene, cam, env, cfg = _scene(), _cam(), _env(), _cfg()
    if second == "pool call":
        _pool(scene, cam, env, cfg)
        before = _counts()
        _pool(scene, cam, env, cfg, seed=1)
        assert _since(before) == {k: (0, 1) for k in CACHES}
    else:
        RenderSession(scene, cam, env, cfg, key=1, device="cpu").step(1)
        before = _counts()
        RenderSession(scene, _cam(lookfrom=(10.0, 3.0, 5.0)), env, cfg,
                      key=2, device="cpu").step(1)
        assert _since(before) == {"tables": (0, 1), "params": (1, 0)}


def _edit_albedo(scene):
    scene.materials.albedo[0, 0] += 0.25


def _edit_centre(scene):
    scene.spheres.center[1, 1] += 0.5


@pytest.mark.parametrize("edit", [_edit_albedo, _edit_centre],
                         ids=["material albedo", "sphere centre"])
def test_an_in_place_edit_rebuilds_the_tables(edit, monkeypatch):
    """An in-place edit of a scene tensor builds the tables anew (the
    tensor's version moved), and the render after it equals one whose
    every value was built fresh."""
    scene, cam, env, cfg = _scene(), _cam(), _env(), _cfg()
    old = tfs.build_tables(scene, env, cfg.env_mode)
    _pool(scene, cam, env, cfg)
    before = _counts()
    edit(scene)
    got, _ = _pool(scene, cam, env, cfg)
    assert _since(before)["tables"] == (1, 0)
    new = tfs.build_tables(scene, env, cfg.env_mode)
    assert not (torch.equal(old.mattab, new.mattab)
                and torch.equal(old.rectab, new.rectab))
    _fresh_caches(monkeypatch)
    want, _ = _pool(scene, cam, env, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change,builds", [
    ("scene", ("tables",)),
    ("environment", ("params",)),
    ("env_mode", ("tables",)),
    ("camera", ("params",)),
    ("HDR environment", ("tables", "params")),
])
def test_other_inputs_rebuild(change, builds):
    """A new scene, a changed environment, a changed env_mode and a new
    camera build what is derived from them, and reuse the rest: the tables
    read the environment in HDR_MAP mode only (its map), so a new sun
    builds only the parameters, and a new map builds the tables too."""
    hdr = change == "HDR environment"
    scene, cam = _scene(), _cam()
    cfg = _cfg(env_mode=tenv.HDR_MAP) if hdr else _cfg()
    env = _env(hdr_image=np.full((4, 8, 3), 0.5, np.float32) if hdr else None)
    _pool(scene, cam, env, cfg)
    if change == "scene":
        scene = _scene()
    elif change == "environment":
        env = _env(sun_direction=(0.2, 0.8, 0.1))
    elif hdr:
        env = _env(hdr_image=np.full((4, 8, 3), 0.25, np.float32))
    elif change == "env_mode":
        cfg = _cfg(env_mode=tenv.SOLID_COLOR)
    else:
        cam = _cam(lookfrom=(10.0, 3.0, 5.0))
    before = _counts()
    _pool(scene, cam, env, cfg)
    assert _since(before) == {k: (1, 0) if k in builds else (0, 1)
                              for k in CACHES}


@pytest.mark.parametrize("variant", ["beauty", "features"])
def test_renders_through_reused_values_equal_fresh_builds(variant,
                                                          monkeypatch):
    """A render whose tables and parameters were reused equals, bit for bit
    and in its segments and steps, the same render with every value built
    fresh: beauty, and fog with every AOV and both split passes."""
    features = variant == "features"
    scene = _scene(use_fog=True, fog_density=0.05) if features else _scene()
    cam, env = _cam(), _env()
    cfg = _cfg(use_albedo=features, use_normal=features,
               use_z_depth=features, use_reflection=features,
               use_refraction=features, samples_per_pixel=2)
    _pool(scene, cam, env, cfg, seed=4)
    before = _counts()
    got, got_stats = _pool(scene, cam, env, cfg, seed=5)
    assert _since(before) == {k: (0, 1) for k in CACHES}
    _fresh_caches(monkeypatch)
    want, want_stats = _pool(scene, cam, env, cfg, seed=5)
    assert tfs.tables_cache.built == 1
    assert got_stats == want_stats
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    if features:
        assert float(got.reflection.abs().sum()) > 0


def test_two_window_threads_of_one_device_build_once():
    """Two windows of one device, each in a thread of its own, build the
    tables once: one window builds, the other waits and reuses."""
    scene, cam, env, cfg = _scene(), _cam(), _env(), _cfg()
    ids = prender._padded_pixel_ids(cfg.n_pixels, 2)
    before = _counts()
    prender.sharded_accumulate(scene, cam, env, 0, cfg, ids, 0,
                               mesh=[torch.device("cpu")] * 2)
    assert _since(before) == {k: (1, 1) for k in CACHES}


def test_builds_on_two_devices_run_at_once():
    """Each device has its own lock: a build on one device does not wait
    for a build on another (both builds are inside at once), while the
    calls of one device take turns."""
    cache = tfs.DerivedCache()
    both_in = threading.Barrier(2, timeout=10)
    errors = []

    def get(device):
        try:
            cache.get(device, (torch.zeros(1),), lambda: both_in.wait())
        except threading.BrokenBarrierError as e:
            errors.append(e)

    threads = [threading.Thread(target=get, args=(torch.device(d),))
               for d in ("cpu", "meta")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and cache.built == 2


def test_the_tables_build_span_marks_only_a_build():
    """Under the profiler the first call's pool.setup holds tables.build
    and the build's read-backs; a call that reuses holds neither."""
    scene, cam, env, cfg = _scene(), _cam(), _env(), _cfg()
    names = []
    for seed in (0, 1):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _pool(scene, cam, env, cfg, seed=seed)
        setup, = [e for e in prof.events() if e.name == "pool.setup"]
        names.append(set(_subtree_names(setup)))
    assert {"tables.build", "aten::_local_scalar_dense"} <= names[0]
    assert not {"tables.build", "aten::_local_scalar_dense"} & names[1]


def _subtree_names(event) -> list:
    out = []
    for child in event.cpu_children:
        out += [child.name, *_subtree_names(child)]
    return out


def test_the_cache_keeps_the_latest_inputs_per_device():
    """A device's entry holds its inputs until other inputs come: then the
    old scene's tensors are let go."""
    scene, cam, env, cfg = _scene(), _cam(), _env(), _cfg()
    _pool(scene, cam, env, cfg)
    old = weakref.ref(scene.spheres.center)
    del scene
    assert old() is not None
    _pool(_scene(), cam, env, cfg)
    assert old() is None


def test_derived_cache_keys():
    """DerivedCache on its own: the same tensors reuse; a new tensor, an
    in-place edit, a storage swapped under the tensor, another device or a
    changed scalar leaf build, each device keeping its own entry."""
    cache = tfs.DerivedCache()
    calls = []

    def get(inputs, device=torch.device("cpu")):
        return cache.get(device, inputs, lambda: calls.append(1) or len(calls))

    t = torch.zeros(4)
    assert get((t, 1)) == get((t, 1)) == 1
    assert get((t.clone(), 1)) == 2
    assert get((t, 1)) == 3
    t += 1
    assert get((t, 1)) == 4
    t.set_(torch.ones(4))
    assert get((t, 1)) == 5
    assert get((t, 2)) == 6
    assert get((t, 2), torch.device("meta")) == 7
    assert get((t, 2)) == 6
    assert get((t, None)) == 8
    assert (cache.built, cache.reused) == (8, 2)


def test_pool_start_wrapper_passes_its_c_signature(monkeypatch):
    """initial_state's CUDA branch, driven with meta tensors: one launch of
    pool_start_launch with as many arguments as its ctypes signature (the
    stream last), a tensor exactly where it has a pointer, and the state
    and counters in the shapes and dtypes of the plain fill's."""
    seen = []

    def launch(entry, *args):
        types = kernels.SIGNATURES[entry][1]
        assert len(args) + 1 == len(types), entry
        for k, (a, t) in enumerate(zip(args, types)):
            assert isinstance(a, torch.Tensor) == (t is kernels._P), (entry, k)
        seen.append(entry)

    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", launch)
    cam = _cam()
    for spec in (False, True):
        sp = tfs.StepParams(seed=1, sample_offset=2, n_pixels=W * H,
                            width=W, total_work=W * H * (2 if spec else 1),
                            max_depth=3, env_mode=0, use_reflection=spec,
                            n_beauty=W * H, pixel_offset=0)
        p = 100
        got = tfs.initial_state(cam, torch.empty(40, device="meta"), sp, p)
        want = tfs.initial_state_plain(cam, sp, p, "cpu")
        assert [(x.shape, x.dtype) for x in got] == [
            (x.shape, x.dtype) for x in want]
    assert seen == ["pool_start_launch"] * 2
