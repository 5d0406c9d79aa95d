"""The port's interactive loop (utils/interactive.py) on the CPU: the
reference's eight cases (tests/test_interactive.py) against the port's
loop, and one command script through both packages' loops with equal state
and responses after it. Inputs: the reference test's `_tiny_scene` and
`_loop`, built in both packages from the same numbers."""

import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.utils.interactive import InteractiveLoop as JLoop
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.utils import image_io
from raytracer_project_tpu_torch.utils.interactive import InteractiveLoop

torch.set_num_threads(2)

CAMERA = dict(vfov=40.0, lookfrom=(0.0, 1.0, 4.0), lookat=(0.0, 0.5, 0.0))


def _tiny_scene(builder, with_bvh=False):
    b = builder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    lamp = b.materials.diffuse_light("lamp", (4.0, 3.0, 2.0))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, red)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, red)
    b.geometry.add_sphere((0.0, 2.0, 0.0), 0.5, lamp)
    return b.build(with_bvh=with_bvh)


def _config(int_mod, env_mod):
    return int_mod.RenderConfig(
        width=32, height=18, samples_per_pixel=8, max_depth=4,
        env_mode=env_mod.PHYSICAL_SUN, wavefront=True)


def _loop(with_bvh=False, **kw):
    return InteractiveLoop(
        _tiny_scene(TBuilder, with_bvh), tenv.make_environment(),
        _config(tint, tenv), dict(CAMERA), key=0, chunk_samples=2,
        device="cpu", **kw)


def _ref_loop(**kw):
    return JLoop(
        _tiny_scene(JBuilder, True), jenv.make_environment(),
        _config(jint, jenv), dict(CAMERA), key=jax.random.PRNGKey(0),
        chunk_samples=2, **kw)


def test_post_edit_is_post_only():
    loop = _loop()
    loop.tick()
    loop.tick()
    done_before = loop.session.samples_done
    assert done_before == 4
    before = loop.session.display()
    resp = loop.handle_command("set post.exposure 2.0")
    assert "post-only" in resp
    notes = loop.tick()  # applies needs_update, renders one more chunk
    assert any("post chain updated" in n for n in notes)
    # Accumulator was NOT reset: progress continued from where it was.
    assert loop.session.samples_done == done_before + 2
    after = loop.session.display()
    assert not np.array_equal(before, after)  # brighter image
    assert loop.session.post_params.exposure.device == loop.device


def test_camera_edit_restarts():
    loop = _loop()
    loop.tick()
    assert loop.session.samples_done == 2
    old_du = loop.session.camera.pixel_delta_u.numpy()
    resp = loop.handle_command("set camera.vfov 20")
    assert "restart" in resp
    notes = loop.tick()
    assert any("restart" in n for n in notes)
    # Accumulator zeroed, then exactly one fresh chunk accumulated.
    assert loop.session.samples_done == 2
    assert loop.camera_params["vfov"] == 20.0
    # The session really runs the new camera (narrower field of view).
    new_du = loop.session.camera.pixel_delta_u.numpy()
    assert np.linalg.norm(new_du) < np.linalg.norm(old_du)


def test_env_and_config_edits_restart():
    loop = _loop()
    loop.tick()
    loop.handle_command("set env.sun_intensity 2.5")
    loop.tick()
    assert float(loop.env.sun_intensity) == 2.5
    assert loop.session.samples_done == 2
    loop.handle_command("set config.samples_per_pixel 4")
    loop.tick()
    assert loop.target_spp == 4
    # Render-to-target stops at the new spp.
    for _ in range(6):
        loop.tick()
    assert loop.session.samples_done == 4


def test_astronomical_sun_syncs_ui():
    loop = _loop()
    resp = loop.handle_command("sun 45 172 12")  # noon, midsummer, 45N
    assert "astronomical" in resp
    notes = loop.tick()
    assert any("sun synced" in n for n in notes)
    d = loop.env.sun_direction.numpy()
    assert d[1] > 0.8  # high noon sun
    # Derived auto color applied (main.cpp:855-871).
    assert float(loop.env.sun_color[0]) == pytest.approx(1.0, abs=1e-3)


def test_pass_switch_save_and_stats(tmp_path):
    loop = _loop()
    loop.config = dataclasses.replace(loop.config, use_albedo=True,
                                      use_normal=True)
    loop.should_restart = True
    loop.tick()
    assert "albedo" in loop.handle_command("pass albedo")
    out = str(tmp_path / "albedo.png")
    assert out in loop.handle_command(f"save albedo {out}")
    assert os.path.exists(out)
    stats = loop.handle_command("stats")
    assert "spp" in stats
    shown = loop.handle_command("show all")
    assert "camera:" in shown and "env:" in shown and "post:" in shown


def test_scene_file_watch_triggers_restart(tmp_path):
    doc = {
        "render": {"width": 32, "height": 18, "samples_per_pixel": 8,
                   "max_depth": 4},
        "environment": {"mode": "sun"},
        "camera": {"vfov": 40.0, "lookfrom": [0.0, 1.0, 4.0],
                   "lookat": [0.0, 0.5, 0.0]},
        "materials": {
            "red": {"type": "lambertian", "albedo": [0.7, 0.2, 0.1]},
        },
        "objects": [
            {"type": "sphere", "center": [0.0, -100.5, 0.0],
             "radius": 100.0, "material": "red"},
            {"type": "sphere", "center": [0.0, 0.5, 0.0], "radius": 0.5,
             "material": "red"},
        ],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(doc))
    loop = _loop(scene_file=str(path))
    loop.tick()
    assert loop.session.samples_done == 2
    doc["objects"].append({"type": "sphere", "center": [1.5, 0.5, 0.0],
                           "radius": 0.5, "material": "red"})
    path.write_text(json.dumps(doc))
    os.utime(path, (0, 2_000_000_000))  # force a new mtime
    notes = loop.tick()
    assert any("restart" in n for n in notes)
    # The reloaded world is the edited file (2 + 1 spheres), not the
    # construction-time scene.
    assert loop.scene.spheres.count == 3
    assert np.allclose(loop.scene.spheres.center.numpy()[-1], [1.5, 0.5, 0.0])
    assert loop.session.samples_done == 2  # fresh accumulator + 1 chunk


def test_run_loop_with_scripted_stdin(tmp_path):
    cmds = io.StringIO("set post.exposure 1.5\nquit\n")
    out = io.StringIO()
    loop = _loop(watch_png=str(tmp_path / "preview.png"))
    loop.run(stdin=cmds, max_ticks=20, out=out)
    text = out.getvalue()
    assert "post-only" in text or "post chain updated" in text
    assert image_io.read_png(str(tmp_path / "preview.png")).shape == (18, 32, 3)


def test_error_handling():
    loop = _loop()
    assert "error" in loop.handle_command("set post.bogus 1")
    assert "error" in loop.handle_command("flibber")
    assert "commands" in loop.handle_command("help")


SCRIPT = ("set post.exposure 1.5\npass albedo\nstats\npass rgb\nwire 2\n"
          "set camera.vfov 35\nsun 45 172 12\nset env.sun_intensity 3\n"
          "show all\nquit\n")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_scripted_state_matches_reference(tmp_path):
    """One command script (post edit, pass switches, stats, the wireframe,
    a camera edit, the astronomical sun, an env edit, show) through both
    packages' loops, each with a preview PNG over a scene with a BVH: the
    responses, camera_params, post_params, config, the sun's direction and
    colour and samples_done agree after it; the stats line's histogram is
    each package's own image, so only its spp line and average (1e-3) are
    compared."""
    port = _loop(with_bvh=True, watch_png=str(tmp_path / "port.png"))
    ref = _ref_loop(watch_png=str(tmp_path / "ref.png"))
    outs = []
    for loop in (port, ref):
        buf = io.StringIO()
        loop.run(stdin=io.StringIO(SCRIPT), max_ticks=30, out=buf)
        outs.append(buf.getvalue().split("\n"))
    got, want = outs
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if "A=avg" in a:
            assert float(a.split("A=avg ")[1].split()[0]) == pytest.approx(
                float(b.split("A=avg ")[1].split()[0]), rel=1e-3)
        elif a.startswith("|") or a.startswith("luma histogram"):
            continue
        else:
            assert a == b
    assert port.camera_params == ref.camera_params
    for name, v in port.post_params._asdict().items():
        np.testing.assert_allclose(_np(v), _np(getattr(ref.post_params, name)),
                                   rtol=1e-7, err_msg=name)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    for name in ("sun_direction", "sun_color", "sun_intensity"):
        np.testing.assert_allclose(_np(getattr(port.env, name)),
                                   _np(getattr(ref.env, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert port.session.samples_done == ref.session.samples_done > 0
    assert port.current_pass == ref.current_pass and port.wire == ref.wire
    assert image_io.read_png(str(tmp_path / "port.png")).shape == (18, 32, 3)
