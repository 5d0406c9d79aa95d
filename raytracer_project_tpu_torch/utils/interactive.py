"""Interactive adjust-while-rendering control loop (twin of
raytracer_project_tpu/utils/interactive.py).

Headless replacement for the reference engine's ImGui control panel and
central restart protocol (main.cpp:274-275 dirty flags, tab panels
:277-1383, restart :1484-1534): a command channel (stdin lines or
programmatic `handle_command`) plus optional scene-file watching drive a
progressive render, and every edit is routed through the reference's
dirty-flag trichotomy:

  should_restart   scene/camera/environment/config edits -> rebuild the
                   world and ZERO the accumulator (main.cpp:1485-1534;
                   the progressive render then restarts from 0 spp while
                   the loop keeps serving preview frames)
  needs_update     post-process edits -> re-run the post chain over the
                   UNTOUCHED accumulator (color_processing.hpp:67;
                   main.cpp:1003 "post.needs_update = true")
  needs_ui_sync    engine-derived environment state (astronomical sun
                   position/auto color) surfaced back to the user
                   (environment.hpp:17,24-29; main.cpp:596-613)

Run it as `python -m raytracer_project_tpu_torch interactive
[--scene-file scene.json]`; type `help` at the prompt. Scene-file edits on
disk are picked up between chunks (the no-recompile workflow the reference
engine markets, minus the GUI). Field edits build tensors on the session's
device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import os
import select
import sys
import time

import numpy as np
import torch

from ..models import camera as cam_mod
from ..models import environment as env_mod
from ..ops import integrator, post as post_mod
from . import applog
from .session import PASS_NAMES, RenderSession, as_key

# Name -> pass id (the reference's pass dropdown, main.cpp:482-564).
PASS_IDS = {name: pid for pid, name in PASS_NAMES.items()}

_ENV_MODES = {"sun": env_mod.PHYSICAL_SUN, "hdr": env_mod.HDR_MAP,
              "solid": env_mod.SOLID_COLOR}

_POST_FIELDS = ("exposure", "saturation", "contrast", "hue_shift",
                "vignette_intensity", "color_balance",
                "exposure_compensation_stops", "target_luminance",
                "bloom_threshold", "bloom_intensity", "sharpen_amount")
_FLAG_FIELDS = ("use_aces", "use_auto_exposure", "use_bloom",
                "bloom_radius", "use_sharpening", "debug_red",
                "debug_green", "debug_blue", "debug_luminance",
                "debug_bvh")
_CAM_FIELDS = ("vfov", "lookfrom", "lookat", "vup", "defocus_angle",
               "focus_dist")
_ENV_FIELDS = ("sun_direction", "sun_color", "sun_intensity", "sun_size",
               "intensity", "background_color", "hdri_rotation",
               "hdri_tilt", "hdri_roll")
_CFG_FIELDS = ("samples_per_pixel", "max_depth", "width", "height")


def _parse_vals(vals):
    out = []
    for v in vals:
        if v in ("on", "true", "yes"):
            out.append(True)
        elif v in ("off", "false", "no"):
            out.append(False)
        else:
            out.append(float(v))
    return out[0] if len(out) == 1 else tuple(out)


class InteractiveLoop:
    """Progressive render + command channel + dirty-flag protocol."""

    def __init__(self, scene, env, config, camera_params: dict,
                 post_params=None, post_config=None, log=None, key=None,
                 chunk_samples: int = 2, scene_file: str | None = None,
                 watch_png: str | None = None,
                 watch_interval: float = 0.15, device=None):
        self.log = log or applog.AppLog(echo=False)
        self.device = integrator.resolve_device(device)
        self.scene = scene.to(self.device)
        self.env = env.to(self.device)
        self.config = config
        self.camera_params = dict(camera_params)
        self.post_params = (post_params
                            or post_mod.make_post_params()).to(self.device)
        self.post_config = post_config or post_mod.PostConfig()
        self.key = as_key(key)
        self.chunk_samples = chunk_samples
        self.scene_file = scene_file
        self._scene_mtime = (os.path.getmtime(scene_file)
                             if scene_file else None)
        self.watch_png = watch_png
        self.watch_interval = watch_interval
        self._last_preview = 0.0

        self.current_pass = post_mod.PASS_RGB
        self.wire = None          # (level, thickness) overlay when set
        self.target_spp = config.samples_per_pixel
        self.paused = False
        self.running = True

        # The dirty-flag trio (main.cpp:274-275; environment.hpp:17).
        self.should_restart = False
        self.needs_update = False
        self.needs_ui_sync = False
        self._sync_lines: list[str] = []

        self.session = self._make_session()

    # -- construction -------------------------------------------------------

    def _make_camera(self):
        return cam_mod.make_camera(
            image_width=self.config.width, image_height=self.config.height,
            **self.camera_params)

    # -- dirty-flag protocol (the reference's central restart,
    # main.cpp:1484-1534) ---------------------------------------------------

    def _apply_dirty(self) -> list[str]:
        notes = []
        if self.should_restart:
            self.session = self._make_session()  # rebuild + zero accumulator
            self.should_restart = False
            self.needs_update = False
            notes.append("[Render] restart: world rebuilt, accumulator reset")
        elif self.needs_update:
            # Post-only: the accumulator is untouched; the next preview
            # re-runs the post chain with the new params.
            self.session.post_params = self.post_params
            self.session.post_config = self.post_config
            self.needs_update = False
            self._last_preview = 0.0  # force a refresh
            notes.append("[Config] post chain updated (render continues)")
        if self.needs_ui_sync:
            notes.extend(self._sync_lines)
            self._sync_lines = []
            self.needs_ui_sync = False
        return notes

    # -- command handling ----------------------------------------------------

    def handle_command(self, line: str) -> str:
        """Apply one command line; returns the response text."""
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        try:
            return self._dispatch(cmd, args)
        except (ValueError, KeyError, IndexError) as e:
            return f"error: {e} (try `help`)"

    def _dispatch(self, cmd, args) -> str:
        if cmd == "help":
            return self._help()
        if cmd == "quit":
            self.running = False
            return "bye"
        if cmd == "pause":
            self.paused = True
            return "paused (preview/commands still live)"
        if cmd == "resume":
            self.paused = False
            return "resumed"
        if cmd == "reset":
            self.should_restart = True
            return "restart queued"
        if cmd == "pass":
            name = args[0].lower()
            if name not in PASS_IDS:
                raise ValueError(f"unknown pass {name!r}; "
                                 f"one of {sorted(PASS_IDS)}")
            self.current_pass = PASS_IDS[name]
            self.needs_update = True
            return f"displaying pass {name}"
        if cmd == "save":
            pid = (PASS_IDS[args[0].lower()] if args else self.current_pass)
            path = args[1] if len(args) > 1 else (
                f"output/render_{PASS_NAMES[pid]}.png")
            return f"saved {self.session.save_render_pass(pid, path)}"
        if cmd == "saveall":
            paths = self.session.save_all_passes(args[0] if args
                                                 else "output")
            return "\n".join(paths)
        if cmd == "stats":
            from . import histview
            stats = self.session.statistics()
            hist = histview.ascii_histogram(
                stats, target_luminance=float(
                    self.post_params.target_luminance))
            return (f"{self.session.samples_done}/{self.target_spp} spp\n"
                    f"{hist}")
        if cmd == "show":
            return self._show(args[0] if args else "all")
        if cmd == "sun":
            return self._astronomical(*[float(a) for a in args])
        if cmd == "wire":
            # BVH wireframe composited over the live render
            # (bvh.hpp:56-109; sliders main.cpp:1058-1085).
            if args and args[0] == "off":
                self.wire = None
                self.needs_update = True
                return "wireframe overlay off"
            level = int(args[0]) if args else -1
            thickness = float(args[1]) if len(args) > 1 else 0.01
            self.wire = (level, thickness)
            self.needs_update = True
            return (f"wireframe overlay on (level={level}, "
                    f"thickness={thickness}) — composited into beauty")
        if cmd == "set":
            return self._set(args[0], args[1:])
        raise ValueError(f"unknown command {cmd!r}")

    def _set(self, target: str, vals) -> str:
        group, _, field = target.partition(".")
        v = _parse_vals(vals)
        if group == "post":
            if field not in _POST_FIELDS:
                raise ValueError(f"post field {field!r}; "
                                 f"one of {_POST_FIELDS}")
            self.post_params = self.post_params._replace(
                **{field: self._f32(v)})
            self.needs_update = True          # redo-post, NOT restart
            return f"post.{field} = {v} (post-only update)"
        if group == "flags":
            if field not in _FLAG_FIELDS:
                raise ValueError(f"flag {field!r}; one of {_FLAG_FIELDS}")
            val = int(v) if field == "bloom_radius" else bool(v)
            self.post_config = dataclasses.replace(self.post_config,
                                                   **{field: val})
            self.needs_update = True
            return f"flags.{field} = {val} (post-only update)"
        if group == "camera":
            if field not in _CAM_FIELDS:
                raise ValueError(f"camera field {field!r}; "
                                 f"one of {_CAM_FIELDS}")
            self.camera_params[field] = v
            self._loaded_camera = None        # explicit edit beats the file
            self.should_restart = True        # restart-scene
            return f"camera.{field} = {v} (restart queued)"
        if group == "env":
            if field == "mode":
                mode = _ENV_MODES[vals[0].lower()]
                self.config = dataclasses.replace(self.config,
                                                  env_mode=mode)
            elif field in _ENV_FIELDS:
                self.env = self.env._replace(**{field: self._f32(v)})
            else:
                raise ValueError(f"env field {field!r}; "
                                 f"one of {('mode',) + _ENV_FIELDS}")
            self.should_restart = True
            return f"env.{field} = {v} (restart queued)"
        if group == "config":
            if field not in _CFG_FIELDS:
                raise ValueError(f"config field {field!r}; "
                                 f"one of {_CFG_FIELDS}")
            self.config = dataclasses.replace(self.config,
                                              **{field: int(v)})
            if field == "samples_per_pixel":
                self.target_spp = int(v)
            self.should_restart = True
            return f"config.{field} = {int(v)} (restart queued)"
        raise ValueError(f"unknown group {group!r}")

    def _f32(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32).to(self.device)

    def _astronomical(self, latitude, day, hour) -> str:
        """set the sun from date/time/latitude (main.cpp:822-893) —
        derived values flow back to the user via needs_ui_sync."""
        elev, az = env_mod.solar_position(latitude, day, hour)
        direction = env_mod.sun_direction_from_time(latitude, day, hour)
        color = env_mod.auto_sun_color(elev)
        self.env = self.env._replace(sun_direction=self._f32(direction),
                                     sun_color=self._f32(color))
        self.should_restart = True
        self.needs_ui_sync = True
        self._sync_lines.append(
            f"[Config] sun synced: elevation {float(elev):.1f} deg, "
            f"azimuth {float(az):.1f} deg, "
            f"color ({', '.join(f'{float(c):.2f}' for c in color)})")
        return "astronomical sun set (restart queued)"

    def _show(self, section: str) -> str:
        out = []
        if section in ("camera", "all"):
            out.append("camera: " + ", ".join(
                f"{k}={v}" for k, v in self.camera_params.items()))
        if section in ("env", "all"):
            e = self.env
            mode = {v: k for k, v in _ENV_MODES.items()}[self.config.env_mode]
            out.append(
                f"env: mode={mode} "
                f"sun_direction={np.round(e.sun_direction.cpu().numpy(), 3)} "
                f"sun_intensity={float(e.sun_intensity)} "
                f"intensity={float(e.intensity)}")
        if section in ("post", "all"):
            p = self.post_params
            out.append(
                f"post: exposure={float(p.exposure):.3f} "
                f"contrast={float(p.contrast):.2f} "
                f"saturation={float(p.saturation):.2f} "
                f"aces={self.post_config.use_aces} "
                f"auto_exposure={self.post_config.use_auto_exposure}")
        if section in ("config", "all"):
            c = self.config
            out.append(f"config: {c.width}x{c.height} "
                       f"spp={self.target_spp} max_depth={c.max_depth} "
                       f"pass={PASS_NAMES[self.current_pass]}")
        if not out:
            raise ValueError(f"unknown section {section!r}")
        return "\n".join(out)

    def _help(self) -> str:
        return (
            "commands:\n"
            "  set post.<f> <v>     exposure/saturation/contrast/... "
            "(post-only; no restart)\n"
            "  set flags.<f> on|off aces/auto_exposure/bloom/sharpening/"
            "debug_* (post-only)\n"
            "  set camera.<f> <v>   vfov/lookfrom/lookat/defocus_angle/"
            "focus_dist (restart)\n"
            "  set env.<f> <v>      mode sun|hdr|solid, sun_*, intensity, "
            "hdri_* (restart)\n"
            "  set config.<f> <v>   samples_per_pixel/max_depth/width/"
            "height (restart)\n"
            "  sun <lat> <day> <hour>  astronomical sun position "
            "(restart + sync)\n"
            "  wire [level] [thickness] | wire off   BVH wireframe "
            "composited over the render\n"
            "  pass <name> | save [pass] [path] | saveall [dir]\n"
            "  stats | show [camera|env|post|config] | reset | pause | "
            "resume | quit"
        )

    # -- the loop ------------------------------------------------------------

    def _check_scene_file(self) -> None:
        if not self.scene_file:
            return
        try:
            mtime = os.path.getmtime(self.scene_file)
        except OSError:
            return
        if mtime != self._scene_mtime:
            self._scene_mtime = mtime
            from ..models import sceneio
            try:
                scene, cam, env, config = sceneio.load_scene_file(
                    self.scene_file)
            except Exception as e:  # keep rendering the old world
                self.log.error("scene reload failed: %s", e)
                return
            self.scene, self.env = scene.to(self.device), env.to(self.device)
            self.config = dataclasses.replace(
                config, samples_per_pixel=self.config.samples_per_pixel)
            # The file's camera wins until the next `set camera.*` edit.
            self._loaded_camera = cam
            self.should_restart = True
            self.log.config("scene file changed on disk: restart queued")

    def _make_session(self) -> RenderSession:
        cam = getattr(self, "_loaded_camera", None) or self._make_camera()
        return RenderSession(self.scene, cam, self.env, self.config,
                             post_params=self.post_params,
                             post_config=self.post_config, log=self.log,
                             key=self.key,
                             chunk_samples=self.chunk_samples,
                             device=self.device)

    def _preview(self) -> None:
        if not self.watch_png:
            return
        now = time.perf_counter()
        if now - self._last_preview < self.watch_interval:
            return
        from . import image_io
        if self.wire is not None and self.current_pass == post_mod.PASS_RGB:
            frame = self.session.display_wire(*self.wire)
        else:
            frame = self.session.display(self.current_pass)
        image_io.save_png(self.watch_png, frame)
        self._last_preview = now

    def tick(self) -> list[str]:
        """One loop iteration: scene-file watch -> dirty-flag protocol ->
        one accumulation chunk -> throttled preview. Returns notes."""
        self._check_scene_file()
        notes = self._apply_dirty()
        if not self.paused and self.session.samples_done < self.target_spp:
            n = min(self.chunk_samples,
                    self.target_spp - self.session.samples_done)
            self.session.step(n)
        self._preview()
        return notes

    def run(self, stdin=None, max_ticks: int | None = None,
            out=None) -> None:
        """Drive tick() until `quit` (or max_ticks), reading commands from
        stdin without blocking between chunks."""
        stdin = stdin if stdin is not None else sys.stdin
        out = out if out is not None else sys.stderr
        ticks = 0
        can_select = hasattr(stdin, "fileno")
        exhausted = False
        while self.running and (max_ticks is None or ticks < max_ticks):
            if can_select:
                try:
                    ready, _, _ = select.select([stdin], [], [], 0.0)
                except (OSError, ValueError):
                    ready, can_select = [], False
                for _ in ready:
                    line = stdin.readline()
                    if not line:       # EOF: finish the render then stop
                        can_select, exhausted = False, True
                        break
                    resp = self.handle_command(line)
                    if resp:
                        print(resp, file=out, flush=True)
            elif not exhausted:
                # No selectable fd (scripted StringIO): drain one command
                # per tick.
                line = stdin.readline()
                if not line:
                    exhausted = True
                else:
                    resp = self.handle_command(line)
                    if resp:
                        print(resp, file=out, flush=True)
            for note in self.tick():
                print(note, file=out, flush=True)
            done = self.session.samples_done >= self.target_spp
            if done and (self.paused or not can_select):
                break
            if done or self.paused:
                time.sleep(0.05)      # idle: wait for commands
            ticks += 1
