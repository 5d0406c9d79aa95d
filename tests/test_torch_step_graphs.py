"""The key of the fused pool's captured steps (ops/step_graphs.py
`StepGraphs.key`), computed on the CPU from what a pool call derives from
its inputs (ops/fused_step.py `_pool_setup`): the values that reach a
captured step through its fixed buffers (the seed, the sample offset,
the AOV budget, the camera) leave the key as it is, so a session's later
updates and frames replay; the stream, the pool size, the kernel variant, the pixel window
and the tables change it, so each captures its own. Also the launch
counts a capture holds and each replay adds (`kernels.held_counts`). The
graphs themselves run on the card only (tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch

from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator
from raytracer_project_tpu_torch.ops import step_graphs

torch.set_num_threads(2)

W, H = 16, 9
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
STREAM = 7


@pytest.fixture(scope="module")
def base():
    """A call's inputs: scene, camera, environment, config, and its
    setup's arguments besides them."""
    scene = presets.showcase_scene(grid=2, with_meshes=False)
    cam = tcam.make_camera(image_width=W, image_height=H, **CAM_KW)
    env = tenv.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=W, height=H, samples_per_pixel=4,
                                  max_depth=3, use_albedo=False,
                                  use_normal=False, use_z_depth=False)
    return dict(scene=scene, cam=cam, env=env, config=cfg, seed=0, aux=1,
                sample_offset=0)


def _key(call, stream=STREAM):
    """The captured step's key of a pool call, and what it was made from
    (held, so that no id is reused while the keys are compared)."""
    tables, _, bparams, sp, p = tfs._pool_setup(**call)
    return (step_graphs.StepGraphs.key(tables, sp, p, torch.device("cpu"),
                                       stream),
            (tables, bparams))


SAME = {
    "seed": lambda c: dict(c, seed=123456789),
    "sample_offset": lambda c: dict(c, sample_offset=28),
    "aux": lambda c: dict(c, aux=0),
    "camera": lambda c: dict(c, cam=tcam.make_camera(
        image_width=W, image_height=H, vfov=40.0, lookfrom=(-9.0, 3.0, 7.0),
        lookat=(0.0, 0.5, 0.0))),
}


@pytest.mark.parametrize("change", list(SAME))
def test_key_ignores_what_reaches_the_fixed_buffers(base, change):
    (key, held), (other, held2) = _key(base), _key(SAME[change](base))
    assert key == other
    if change == "camera":
        assert not torch.equal(held[1], held2[1])


def _cfg(c, **kw):
    return dict(c, config=dataclasses.replace(c["config"], **kw))


OTHER = {
    "pool_size": lambda c: _cfg(c, pool_lanes=4096, samples_per_pixel=64),
    "aovs": lambda c: _cfg(c, use_albedo=True),
    "split_passes": lambda c: _cfg(c, use_reflection=True),
    "depth": lambda c: _cfg(c, max_depth=5),
    "env_mode": lambda c: _cfg(c, env_mode=tenv.SOLID_COLOR),
    "tables": lambda c: dict(c, scene=presets.showcase_scene(
        grid=2, with_meshes=False, seed=5)),
    "fog": lambda c: dict(c, scene=presets.showcase_scene(
        grid=2, with_meshes=False, use_fog=True)),
    "window": lambda c: dict(c, pixel_offset=64, n_pixels_local=64),
}


@pytest.mark.parametrize("change", list(OTHER) + ["stream"])
def test_key_follows_the_shape_the_variant_and_the_tables(base, change):
    key, held = _key(base)
    if change == "stream":
        other, held2 = _key(base, stream=STREAM + 1)
    else:
        other, held2 = _key(OTHER[change](base))
    assert key != other
    assert key[:2] == other[:2] or change == "stream"
    if change in ("tables", "fog", "env_mode"):
        assert held[0] is not held2[0]
    if change == "pool_size":
        assert key[3] != other[3]


def test_held_counts_are_added_once_per_replay():
    """Counts made inside `held_counts` (a capture) add nothing and are
    handed back in order; `count_all` adds each once (a replay)."""

    def wrapper():
        pass

    wrapper.launches = wrapper.other = 0
    with kernels.held_counts() as held:
        kernels.count(wrapper)
        kernels.count(wrapper, "other")
        kernels.count(wrapper, "other")
    assert wrapper.launches == wrapper.other == 0
    assert held == [(wrapper, "launches"), (wrapper, "other"),
                    (wrapper, "other")]
    for _ in range(3):
        kernels.count_all(held)
    assert (wrapper.launches, wrapper.other) == (3, 6)
    kernels.count(wrapper)
    assert wrapper.launches == 4
