"""Progressive render session: accumulate, preview, cancel, checkpoint (twin
of raytracer_project_tpu/utils/session.py).

The reference engine's render thread and dirty-flag state machine
(main.cpp:1395-1645, camera.hpp:209-343) as a library object:

 * progressive accumulation in sample chunks: each `step` is one
   integrator.accumulate_samples call from the samples done so far on
   (the fused pool on the card: K1, K3 fused), added into the session's sums;
 * every chunk counts its AOV samples against the whole render's budget
   (`aux_samples`, which is min(aux_samples, samples_per_pixel) for the
   samples of the render), so the progressive AOVs equal the one-shot
   render's. The reference package renders each chunk with the chunk's own
   budget, and its progressive AOVs count the first chunk only;
 * cooperative cancellation between chunks;
 * checkpoint/resume of (sums, sample count, key, config) in the reference
   package's file format, so checkpoints move between the two packages;
 * per-pass display/export through the post chain, the denoisers at
   display time, and the BVH wireframe over the live render;
 * progress/ETA and rays/s (main.cpp:1399-1424);
 * mesh=[devices] splits each step's pixels over the devices, every
   window at once (parallel/render.sharded_accumulate). Under a
   torch.distributed group of more than one process, mesh and owners come
   from distributed.make_global_mesh: each rank renders the windows it owns
   (one or several cards) and `buffers()` gathers the windows of every
   rank (distributed.all_gather: on the cards under NCCL).

The reference engine's dirty flags map to:
  should_restart  -> RenderSession.reset() (new accumulator)
  needs_update    -> display()/export re-runs the post chain only
  needs_ui_sync   -> plain attribute reads (no hidden engine state)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..core import rng
from ..models import camera as cam_mod
from ..ops import integrator, post as post_mod
from ..parallel import distributed, render as prender
from . import applog, image_io, spans

PASS_BUFFERS = {
    post_mod.PASS_RGB: "beauty",
    post_mod.PASS_DENOISE: "beauty",   # denoiser applied at display time
    post_mod.PASS_ALBEDO: "albedo",
    post_mod.PASS_NORMALS: "normal",
    post_mod.PASS_REFLECTIONS: "reflection",
    post_mod.PASS_REFRACTIONS: "refraction",
    post_mod.PASS_Z_DEPTH: "z_depth",
}

PASS_NAMES = {
    post_mod.PASS_RGB: "rgb",
    post_mod.PASS_DENOISE: "denoise",
    post_mod.PASS_ALBEDO: "albedo",
    post_mod.PASS_NORMALS: "normals",
    post_mod.PASS_REFLECTIONS: "reflections",
    post_mod.PASS_REFRACTIONS: "refractions",
    post_mod.PASS_Z_DEPTH: "z_depth",
}


def to_u8(img) -> np.ndarray:
    """A post-processed [H, W, 3] image as host uint8 (the reference's
    clip(img * 255.999, 0, 255) and truncation)."""
    return torch.clamp(img * 255.999, 0.0, 255.0).to(torch.uint8).cpu().numpy()


def as_key(key) -> rng.Key:
    """An rng.Key from a seed (PRNGKey(seed) is Key(0, seed)) or a Key."""
    if isinstance(key, rng.Key):
        return key
    return rng.Key(0, int(key or 0))


class RenderSession:
    """Owns the progressive accumulator on `device` (default the card,
    integrator.resolve_device). With a mesh, on the device of this
    process's first window: owners[i] is the rank that renders window i
    (distributed.make_global_mesh; None, one process renders them all)."""

    def __init__(self, scene, camera: cam_mod.Camera,
                 env, config: integrator.RenderConfig,
                 post_params: post_mod.PostParams | None = None,
                 post_config: post_mod.PostConfig | None = None,
                 key=None, log: applog.AppLog | None = None,
                 mesh=None, owners=None, chunk_samples: int = 4,
                 device=None):
        with spans.span("session.create"):
            self._rank, world = distributed._world()
            self._ranks = world if mesh is not None else 1
            if mesh is not None:
                if owners is None:
                    if self._ranks > 1:
                        raise ValueError(
                            f"a mesh under {self._ranks} ranks needs its "
                            "owners (distributed.make_global_mesh)")
                    owners = [self._rank] * len(mesh)
                if len(owners) != len(mesh):
                    raise ValueError(f"{len(owners)} owners for a mesh of "
                                     f"{len(mesh)} entries")
                self._windows = distributed.my_windows(owners)
            self.device = (torch.device(mesh[self._windows[0]])
                           if mesh is not None
                           else integrator.resolve_device(device))
            self.scene = scene.to(self.device)
            self.camera = camera.to(self.device)
            self.env = env.to(self.device)
            self.config = config
            self.post_params = (post_params
                                or post_mod.make_post_params()).to(self.device)
            self.post_config = post_config or post_mod.PostConfig()
            self.key = as_key(key)
            self.log = log or applog.AppLog()
            self.mesh = mesh
            self.chunk_samples = chunk_samples
            self._denoiser = None

            n = config.n_pixels
            if mesh is None:
                self._ids = None
                self._n_pad = self._n_local = n
                self._start = 0
            else:
                self._ids = prender._padded_pixel_ids(n, len(mesh))
                self._n_pad = int(self._ids.shape[0])
                # Rows this process holds: its windows, from window
                # _windows[0].
                per = self._n_pad // len(mesh)
                self._n_local = per * len(self._windows)
                self._start = per * self._windows[0]
            self.cancel_requested = False
            self._start_time: float | None = None
            self.reset()
            self.log.render("-Zenith-TPU engine session created (%dx%d)",
                            config.width, config.height)

    # -- accumulation -------------------------------------------------------

    def reset(self) -> None:
        """Zero all buffers + sample counter (camera.hpp:209-233)."""
        self.acc = integrator.SampleBuffers(*(
            torch.zeros((self._n_local, 3), dtype=torch.float32,
                        device=self.device)
            for _ in integrator.SampleBuffers._fields))
        self.samples_done = 0
        self.segments_traced = 0.0
        self.cancel_requested = False
        self._start_time = None

    def _accumulate(self, cfg):
        """(sums, stats) of cfg.samples_per_pixel samples from samples_done
        on, each counted against the whole render's AOV budget."""
        kw = dict(with_stats=True, aux=self.config.aux_samples)
        if self.mesh is not None:
            return prender.sharded_accumulate(
                self.scene, self.camera, self.env, self.key, cfg, self._ids,
                self.samples_done, mesh=self.mesh, windows=self._windows, **kw)
        return integrator.accumulate_samples(
            self.scene, self.camera, self.env, self.key, cfg, None,
            self.samples_done, **kw)

    def step(self, n_samples: int | None = None) -> int:
        """Accumulate one chunk of samples; returns samples done so far."""
        n_samples = n_samples or self.chunk_samples
        with spans.span("session.step"):
            cfg = dataclasses.replace(self.config,
                                      samples_per_pixel=n_samples)
            if self._start_time is None:
                self._start_time = time.perf_counter()
            t0 = time.perf_counter()
            delta, stats = self._accumulate(cfg)
            self.acc = integrator.SampleBuffers(*(
                a + b for a, b in zip(self.acc, delta)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.samples_done += n_samples
            bound = applog.rays_per_second(
                self.config.width, self.config.height, n_samples,
                self.config.max_depth, dt)
            if stats.get("segments", 0) > 0:
                self.segments_traced += float(stats["segments"])
                measured = applog.measured_rays_per_second(
                    stats["segments"], dt)
                self.log.debug(
                    "chunk %d samples in %.2fs (%.1f Mrays/s measured, "
                    "%.1f bound)", n_samples, dt, measured / 1e6, bound / 1e6)
            else:
                self.log.debug(
                    "chunk %d samples in %.2fs (%.1f Mrays/s bound)",
                    n_samples, dt, bound / 1e6)
        return self.samples_done

    def render_progressive(self, total_samples: int,
                           callback=None) -> None:
        """Drive accumulation to `total_samples` with cancellation between
        chunks (the reference engine's per-scanline flag,
        camera.hpp:441-443)."""
        while self.samples_done < total_samples and not self.cancel_requested:
            n = min(self.chunk_samples, total_samples - self.samples_done)
            self.step(n)
            if callback is not None:
                callback(self)

    def cancel(self) -> None:
        """Cooperative stop; partial accumulators are preserved
        (main.cpp:1447-1461)."""
        self.cancel_requested = True
        self.log.render("Render cancelled at %d samples", self.samples_done)

    # -- progress / metrics (main.cpp:1399-1424) ---------------------------

    def progress(self, total_samples: int) -> float:
        return min(1.0, self.samples_done / max(total_samples, 1))

    def eta_seconds(self, total_samples: int) -> float:
        if self.samples_done == 0 or self._start_time is None:
            return float("inf")
        elapsed = time.perf_counter() - self._start_time
        rate = self.samples_done / elapsed
        return max(0.0, (total_samples - self.samples_done) / max(rate, 1e-9))

    # -- display / export ---------------------------------------------------

    def _acc_frame(self) -> integrator.SampleBuffers:
        """The frame's sums [n_pixels, 3]: the windows of every rank
        gathered (on every rank) under several ranks, the padding cut."""
        n = self.config.n_pixels
        acc = self.acc
        if self._ranks > 1:
            acc = integrator.SampleBuffers(*(
                distributed.all_gather(x).to(self.device) for x in acc))
        if acc.beauty.shape[0] == n:
            return acc
        return integrator.SampleBuffers(*(x[:n] for x in acc))

    def buffers(self) -> dict:
        """Averaged linear buffers [H, W, 3] on the session's device."""
        with spans.span("session.buffers"):
            return integrator.finalize_buffers(
                self._acc_frame(), self.config,
                total_samples=max(self.samples_done, 1))

    def statistics(self) -> post_mod.ImageStatistics:
        """Image statistics of the averaged beauty. Under several ranks each
        rank reduces its own windows' pixels (their padding rows cut) over
        the group, without gathering the image."""
        if self._ranks > 1:
            rows = max(0, min(self.config.n_pixels - self._start,
                              self._n_local))
            img = self.acc.beauty[:rows] / max(self.samples_done, 1)
            return post_mod.analyze_framebuffer_psum(img)
        return post_mod.analyze_framebuffer(self.buffers()["beauty"])

    def resolved_exposure(self):
        """Auto-exposure result fed back into the grade
        (main.cpp:1589-1598)."""
        return post_mod.auto_exposure(self.post_params, self.statistics(),
                                      self.post_config)

    def _graded(self, img, current_pass: int) -> np.ndarray:
        params = self.post_params._replace(exposure=self.resolved_exposure())
        return to_u8(post_mod.update_post_processing(
            img, params, self.post_config, current_pass))

    def display(self, current_pass: int = post_mod.PASS_RGB,
                denoise_specular: bool = False) -> np.ndarray:
        """Post-processed uint8 frame for preview (main.cpp:1538-1645).

        denoise_specular: also denoise the reflection/refraction passes
        with the albedo/normal guides, as the reference engine's OIDN run
        over beauty and the specular AOVs (camera.hpp:270-291).
        """
        b = self.buffers()
        buf = b[PASS_BUFFERS[current_pass]]
        if current_pass == post_mod.PASS_DENOISE or (
            denoise_specular
            and current_pass in (post_mod.PASS_REFLECTIONS,
                                 post_mod.PASS_REFRACTIONS)
        ):
            from ..models import denoiser_unet
            from ..ops import denoise as denoise_mod

            # The learned model when the shipped weights exist (OIDN role,
            # camera.hpp:581-699); the a-trous filter otherwise.
            if self._denoiser is None:
                self._denoiser = (denoiser_unet.load_default(self.device)
                                  or False)
            with torch.no_grad():
                buf = denoise_mod.denoise(buf, b["albedo"], b["normal"],
                                          model=self._denoiser or None)
        return self._graded(buf, current_pass)

    def display_wire(self, level: int = -1,
                     thickness: float = 0.01) -> np.ndarray:
        """Wireframe over the live render: BVH node edges composited INTO
        the beauty buffer, occlusion-correct at primary visibility
        (bvh.hpp:56-109; level/thickness are the reference engine's debug
        sliders, main.cpp:1058-1085). The surface test is K4 on the card."""
        from ..ops import debugviz

        if self.scene.bvh is None:
            raise ValueError("scene has no BVH (build with with_bvh=True)")
        comp = debugviz.composite_wireframe(
            self.scene, self.camera, self.buffers()["beauty"],
            level=level, thickness=thickness)
        return self._graded(comp, post_mod.PASS_RGB)

    def save_render_pass(self, current_pass: int, path: str) -> str:
        """PNG export of one pass (camera.hpp:299-343)."""
        image_io.save_png(path, self.display(current_pass))
        self.log.system("Saved %s pass to %s", PASS_NAMES[current_pass], path)
        return path

    def save_all_passes(self, out_dir: str = "output") -> list[str]:
        """Batch export of all buffers (main.cpp:1327-1355)."""
        paths = []
        for pass_id, name in PASS_NAMES.items():
            if pass_id == post_mod.PASS_DENOISE:
                continue
            paths.append(self.save_render_pass(
                pass_id, os.path.join(out_dir, f"render_{name}.png")))
        return paths

    # -- checkpoint / resume: the reference package's file format ----------

    def checkpoint(self, path: str) -> str:
        """Write the sums (unpadded [n_pixels, 3] f32), the key as its two
        u32 words [hi, lo], samples_done and the config as JSON, with
        np.savez_compressed. Under several ranks every rank gathers and
        rank 0 writes."""
        acc = self._acc_frame()
        if not distributed.is_host0():
            return path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        host = {k: v.cpu().numpy() for k, v in acc._asdict().items()}
        np.savez_compressed(
            path, **host,
            key=np.asarray([self.key.hi, self.key.lo], np.uint32),
            samples_done=self.samples_done,
            config=json.dumps(dataclasses.asdict(self.config)))
        self.log.system("Checkpointed %d samples to %s", self.samples_done, path)
        return path

    def restore(self, path: str) -> None:
        """Read a checkpoint of either package; raises ValueError when its
        config differs from this session's."""
        with np.load(path, allow_pickle=False) as data:
            stored = json.loads(str(data["config"]))
            current = dataclasses.asdict(self.config)
            if stored != current:
                raise ValueError(
                    f"checkpoint config mismatch: {stored} != {current}")
            start = self._start

            def load(k):
                arr = np.asarray(data[k], np.float32)
                pad = self._n_pad - arr.shape[0]
                if pad > 0:  # the sharded layout's padding rows are never
                    # read back: _acc_frame cuts them
                    arr = np.concatenate([arr, np.zeros((pad, 3), arr.dtype)])
                return torch.as_tensor(
                    arr[start:start + self._n_local]).to(self.device)

            self.acc = integrator.SampleBuffers(*(
                load(k) for k in integrator.SampleBuffers._fields))
            self.key = rng.Key(*(int(x) for x in np.asarray(data["key"])))
            self.samples_done = int(data["samples_done"])
        self.log.system("Restored %d samples from %s", self.samples_done, path)
