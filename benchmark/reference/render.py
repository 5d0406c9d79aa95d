"""The reference renderer: sums of a set of pixels over a range of samples.

Paths are keyed by (render key, pixel, sample), as in the port, so the
reference traces only the pixels a run checks, at the run's own frame size,
camera and samples. Every lane starts at its camera ray and is stepped by
the frozen plain K1, K2 and K3 until it finishes; finished radiance is
summed per pixel. Nothing respawns: a lane's path does not depend on the
pool it ran in.

`round_to` puts the control in the program's place: the path state and the
closest-hit distances are rounded to that dtype after every step (bfloat16
for this float32 program: the nearest precision below the configuration's).
"""

from __future__ import annotations

import numpy as np
import torch

from .tracer import camera as camera_mod
from .tracer import closest_hit as k1
from .tracer import environment as env_mod
from .tracer import fused, rng
from .tracer.constants import T_MIN
from .tracer.scene import SceneBuilder

# Lanes per block: bounds the plain K1's [lanes, 512 x outputs] dots.
BLOCK_LANES = 16384


def build_scene(generator, cfg: dict):
    """The configuration's scene from the reference's own builder."""
    b = SceneBuilder()
    generator.build(b, cfg)
    return b.build()


def make_environment(cfg: dict):
    e = dict(cfg["environment"])
    mode = getattr(env_mod, e.pop("mode"))
    return env_mod.make_environment(**e), mode


def make_camera(cam_kw: dict, width: int, height: int):
    return camera_mod.make_camera(image_width=width, image_height=height,
                                  **cam_kw)


class Reference:
    """A configuration's scene tables on `device`, built once."""

    def __init__(self, generator, cfg: dict, device):
        self.device = torch.device(device)
        self.cfg = cfg
        scene = build_scene(generator, cfg).to(self.device)
        self.env, self.env_mode = make_environment(cfg)
        self.env = self.env.to(self.device)
        self.tables = fused.build_tables(scene, self.env, self.env_mode)
        self.aparams = fused._aparams(self.env, self.device)
        self.n_volumes = scene.volumes.count if scene.volumes is not None else 0
        self.max_depth = int(cfg["render"]["max_depth"])

    def sums(self, cam_kw: dict, width: int, height: int, key: int,
             pixel_ids, n_samples: int, sample_offset: int = 0,
             round_to=None) -> torch.Tensor:
        """f32 [len(pixel_ids), 3]: each pixel's beauty summed over samples
        [sample_offset, sample_offset + n_samples) under render key `key`
        (the port's PRNGKey(key))."""
        dev = self.device
        cam = make_camera(cam_kw, width, height).to(dev)
        bparams = fused._bparams(cam, self.env, dev)
        pix = torch.as_tensor(np.asarray(pixel_ids), dtype=torch.int64,
                              device=dev)
        k = pix.shape[0]
        out = torch.zeros((k, 3), dtype=torch.float32, device=dev)
        slot = torch.arange(k, device=dev).repeat(n_samples)
        lanes_li = pix.repeat(n_samples)
        lanes_samp = (sample_offset + torch.arange(
            n_samples, device=dev).repeat_interleave(k))
        sp = fused.StepParams(
            seed=rng.seed_from_int(rng.Key(0, int(key))), sample_offset=0,
            n_pixels=width * height, width=width, total_work=1,
            max_depth=self.max_depth, env_mode=self.env_mode,
            n_volumes=self.n_volumes)
        for b0 in range(0, lanes_li.shape[0], BLOCK_LANES):
            li = lanes_li[b0:b0 + BLOCK_LANES].to(torch.int32)
            samp = lanes_samp[b0:b0 + BLOCK_LANES].to(torch.int32)
            self._trace(cam, bparams, sp, li, samp,
                        slot[b0:b0 + BLOCK_LANES], out, round_to, width)
        return out

    def _trace(self, cam, bparams, sp, li, samp, slot, out, round_to, width):
        dev = self.device
        lr0 = rng.LaneRng(sp.seed, rng.u32(li), rng.u32(samp), 0)
        o0, d0 = camera_mod.generate_rays_soa(cam, lr0, li, width)
        n = li.shape[0]
        ones = torch.ones((n,), dtype=torch.float32, device=dev)
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        state_f = torch.stack([*o0, *d0, ones, ones, ones, zeros, zeros, zeros])
        state_i = torch.stack([torch.ones_like(li), torch.zeros_like(li),
                               samp, li])
        # total_work 1 and next_work 1: K3 respawns nothing.
        next_work = torch.ones((1,), dtype=torch.int32, device=dev)
        segments = torch.zeros((1,), dtype=torch.int64, device=dev)
        slot = slot.clone()
        while state_f.shape[1]:
            t, idx, typ = k1.closest_hit_plain(
                state_f[:6], T_MIN, self.tables.scan.coeffs,
                self.tables.scan.counts)
            if round_to is not None:
                t = t.to(round_to).to(torch.float32)
            rec = fused.decode_plain(self.tables, state_f[:6], t, idx, typ,
                                     self.aparams)
            (state_f, state_i, contrib, tgt, next_work, segments,
             _) = fused.shade_advance_plain(self.tables, rec, state_f, state_i,
                                            next_work, segments, bparams, sp)
            done = tgt[0] < sp.n_pixels
            out.index_add_(0, slot[done], contrib[:3, done].T)
            live = state_i[0] > 0
            state_f, state_i, slot = state_f[:, live], state_i[:, live], slot[live]
            if round_to is not None:
                state_f = state_f.to(round_to).to(torch.float32)
