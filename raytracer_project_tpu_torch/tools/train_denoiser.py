"""Train the denoiser U-Net on the port's own renders (twin of the
repository's tools/train_denoiser.py).

Data: (8 spp noisy beauty + albedo + normal) -> 256 spp target pairs at
96x54 over randomised Shirley-style scenes, the Cornell box and the
showcase (make_case: the reference's numpy draws), rendered through the
fused pool and cached as npz in a directory (default build/denoiser_data/)
so that re-runs skip the renders. The last two pairs are held out for
validation against the a-trous filter and the shipped weights.

Training: random 32x64 crops, 4 per image, horizontally flipped at
random (a torch.Generator seeded 7), L1 loss on log1p; Adam with a cosine
decay of the rate from 2e-3 to 5% over the steps (optax's
cosine_decay_schedule, as the reference uses). The U-Net's convolutions
and their backward run in f32 with cuDNN's TF32 off, as `apply` does.

    python -m raytracer_project_tpu_torch.tools.train_denoiser \
        [--out PATH] [--cache DIR] [--device cpu]

Environment: DN_STEPS (default 800), DN_PAIRS (default 14). Writes the
weights in the reference's npz layout to PATH (default
build/denoiser/denoiser_weights.npz), never into raytracer_project_tpu/.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import goldens

W, H = 96, 54
LOW, HIGH = 8, 256
PH, PW, PER_IMG = 32, 64, 4
LR, ALPHA = 2e-3, 0.05
DEFAULT_OUT = goldens.REPO / "build" / "denoiser" / "denoiser_weights.npz"
DEFAULT_CACHE = goldens.REPO / "build" / "denoiser_data"


def render(scene, cam, env, mode, spp, seed, device, width=W, height=H):
    """(beauty, albedo, normal) [H, W, 3] numpy of one fused-pool render,
    depth 8, albedo and normal AOVs on."""
    from ..ops import integrator

    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=8,
        env_mode=mode, use_albedo=True, use_normal=True, use_z_depth=False,
        wavefront=True)
    out = integrator.render(scene, cam, env, seed, cfg, device=device)
    return {k: out[k].cpu().numpy() for k in ("beauty", "albedo", "normal")}


def make_case(i, width=W, height=H):
    """(scene, camera, environment, env mode) of training case i, from the
    reference's draws of np.random.default_rng(100 + i): a Shirley scene,
    the Cornell box or the showcase, by i % 3."""
    from ..models import camera, environment, presets

    r = np.random.default_rng(100 + i)
    kind = i % 3
    if kind == 0:
        scene = presets.shirley_final_scene(seed=int(r.integers(1, 99)),
                                            grid=int(r.integers(3, 7)),
                                            with_bvh=False)
        dist = 10.0 + r.uniform(-2, 4)
        cam = camera.make_camera(
            image_width=width, image_height=height,
            vfov=float(r.uniform(18, 32)),
            lookfrom=(13 + r.uniform(-3, 3), 2 + r.uniform(0, 2),
                      3 + r.uniform(-2, 2)),
            lookat=(0, 0, 0), defocus_angle=float(r.uniform(0, 0.6)),
            focus_dist=dist)
        env = environment.make_environment(
            sun_direction=(r.uniform(0.1, 0.7), r.uniform(0.3, 0.9),
                           r.uniform(0.0, 0.5)),
            sun_intensity=float(r.uniform(3, 8)))
        return scene, cam, env, environment.PHYSICAL_SUN
    if kind == 1:
        scene = presets.cornell_box_scene(with_bvh=False)
        cam = camera.make_camera(
            image_width=width, image_height=height,
            vfov=float(r.uniform(35, 45)),
            lookfrom=(278 + r.uniform(-60, 60), 278 + r.uniform(-60, 60),
                      -800 + r.uniform(-60, 120)),
            lookat=(278, 278, 0))
        env = environment.make_environment(background_color=(0, 0, 0))
        return scene, cam, env, environment.SOLID_COLOR
    scene = presets.showcase_scene(seed=int(r.integers(1, 99)),
                                   with_bvh=False, with_meshes=True)
    cam = camera.make_camera(
        image_width=width, image_height=height, vfov=30.0,
        lookfrom=(12 + r.uniform(-2, 2), 2.5 + r.uniform(-0.5, 1.5),
                  6 + r.uniform(-2, 2)),
        lookat=(0, 1, 0))
    env = environment.make_environment(
        sun_direction=(r.uniform(0.2, 0.6), r.uniform(0.4, 0.9),
                       r.uniform(0.0, 0.4)),
        sun_intensity=float(r.uniform(4, 8)))
    return scene, cam, env, environment.PHYSICAL_SUN


def get_pair(i, cache, device, width=W, height=H, low=LOW, high=HIGH):
    """Pair i ({beauty, albedo, normal} at `low` spp, target = beauty at
    `high` spp; seed 1000 + i for both), from the cache or rendered and
    cached."""
    path = Path(cache) / f"pair_{i:02d}_{width}x{height}_{low}-{high}spp.npz"
    if path.exists():
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    scene, cam, env, mode = make_case(i, width, height)
    lo = render(scene, cam, env, mode, low, 1000 + i, device, width, height)
    hi = render(scene, cam, env, mode, high, 1000 + i, device, width, height)
    pair = {"beauty": lo["beauty"], "albedo": lo["albedo"],
            "normal": lo["normal"], "target": hi["beauty"]}
    np.savez(path, **pair)
    print(f"[data] rendered pair {i}", flush=True)
    return pair


def crops(gen: torch.Generator, b, a, n, t):
    """PER_IMG random PH x PW crops of every image of the [N, H, W, 3]
    stacks, each flipped horizontally with probability 1/2; the draws come
    from `gen` (a CPU generator)."""
    n_img, h, w = b.shape[0], b.shape[1], b.shape[2]
    m = n_img * PER_IMG
    img = torch.randint(0, n_img, (m,), generator=gen)
    oy = torch.randint(0, h - PH, (m,), generator=gen)
    ox = torch.randint(0, w - PW, (m,), generator=gen)
    flip = torch.rand((m,), generator=gen) < 0.5
    rows = oy[:, None] + torch.arange(PH)
    cols = ox[:, None] + torch.arange(PW)
    cols = torch.where(flip[:, None], cols.flip(1), cols)
    idx = [x.to(b.device) for x in (img[:, None, None], rows[:, :, None],
                                     cols[:, None, :])]
    return tuple(src[idx[0], idx[1], idx[2]] for src in (b, a, n, t))


def loss_fn(params, b, a, n, t):
    """The reference's loss: mean |log1p(unet(b, a, n)) - log1p(t)| over a
    batch of [N, H, W, 3] crops."""
    from ..models import denoiser_unet

    pred = denoiser_unet.apply_batch(params, b, a, n)
    return (torch.log1p(pred) - torch.log1p(t)).abs().mean()


def cosine_decay(step: int, steps: int, alpha: float = ALPHA) -> float:
    """optax.cosine_decay_schedule's factor at `step` of `steps`."""
    frac = min(step, steps) / steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha


def optimizer(parameters, steps: int):
    """(torch.optim.Adam at LR, its LambdaLR of cosine_decay): optax's
    adam(cosine_decay_schedule(LR, steps, ALPHA))."""
    opt = torch.optim.Adam(parameters, lr=LR)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: cosine_decay(s, steps))
    return opt, sched


def train(pairs, steps: int, device, seed: int = 7, t0: float | None = None):
    """Train a U-Net (init_params(0)) on `pairs`: (DenoiserUNet, the
    loss of every step)."""
    from ..models import denoiser_unet

    t0 = time.time() if t0 is None else t0
    stack = lambda k: torch.from_numpy(np.stack([p[k] for p in pairs])).to(device)
    tb, ta, tn, tt = (stack(k) for k in ("beauty", "albedo", "normal", "target"))
    model = denoiser_unet.DenoiserUNet(seed=0).to(device)
    print("[train] params:", denoiser_unet.param_count(model.params()),
          flush=True)
    opt, sched = optimizer(model.parameters(), steps)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for s in range(steps):
        b, a, n, t = crops(gen, tb, ta, tn, tt)
        opt.zero_grad()
        with denoiser_unet._no_tf32():
            loss = loss_fn(model.params(), b, a, n, t)
            loss.backward()
        opt.step()
        sched.step()
        losses.append(float(loss.detach()))
        if s % 200 == 0 or s == steps - 1:
            print(f"[train] step {s}: loss {losses[-1]:.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return model, losses


def validate(model, val, device) -> list[dict]:
    """PSNR (dB) against each held-out pair's target of the raw render,
    the a-trous filter, the trained U-Net and the shipped weights."""
    from ..models import denoiser_unet
    from ..ops import denoise
    from ..utils import metrics

    shipped = denoiser_unet.load_default(device=device)
    rows = []
    with torch.no_grad():
        for j, p in enumerate(val):
            b, a, n, t = (torch.from_numpy(p[k]).to(device)
                          for k in ("beauty", "albedo", "normal", "target"))
            row = {"raw": b, "atrous": denoise.atrous_denoise(b, a, n),
                   "unet": model(b, a, n)}
            if shipped is not None:
                row["shipped"] = shipped(b, a, n)
            row = {k: float(metrics.psnr(v, t)) for k, v in row.items()}
            print(f"[val {j}] raw {row['raw']:.2f} atrous {row['atrous']:.2f} "
                  f"unet {row['unet']:.2f} dB", flush=True)
            if "shipped" in row:
                print(f"[val {j}] shipped weights {row['shipped']:.2f} dB",
                      flush=True)
            rows.append(row)
    return rows


def main(steps=None, pairs=None, out=DEFAULT_OUT, cache=DEFAULT_CACHE,
         device=None, width=W, height=H, low=LOW, high=HIGH) -> dict:
    """Render (or read) the pairs, train, validate on the last two and
    write the weights to `out`. Returns {"data_s", "train_s", "losses",
    "val", "out", "model"}."""
    from ..models import denoiser_unet
    from ..ops.integrator import resolve_device

    steps = int(os.environ.get("DN_STEPS", 800)) if steps is None else steps
    pairs = int(os.environ.get("DN_PAIRS", 14)) if pairs is None else pairs
    out = goldens.writable_dir(Path(out).parent) / Path(out).name
    cache = goldens.writable_dir(cache)
    dev = resolve_device(device)
    t0 = time.time()
    data = [get_pair(i, cache, dev, width, height, low, high)
            for i in range(pairs)]
    data_s = time.time() - t0
    print(f"[data] {pairs} pairs in {data_s:.0f}s", flush=True)
    t1 = time.time()
    model, losses = train(data[:-2], steps, dev, t0=t0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t1
    val = validate(model, data[-2:], dev)
    denoiser_unet.save_params(out, model.params())
    print("[done] saved", out, flush=True)
    return {"data_s": data_s, "train_s": train_s, "losses": losses,
            "val": val, "out": out, "model": model}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cache", default=str(DEFAULT_CACHE))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(out=args.out, cache=args.cache, device=args.device)
    sys.exit(0)
