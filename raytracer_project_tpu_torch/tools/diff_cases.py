"""The gradient cases of the reference's tests/test_gradients.py, for the
port: `tiny_state` (its _tiny_state: four spheres, 24x16 @ 2 spp, depth
4) and its five central finite-difference checks (`FD_CHECKS`,
`fd_check`). `search_agreement` says where two recordings of one render's
closest-hit searches agree (the card's K4 against its plain version on the
CPU), so that card and CPU autograd can be held against each other where
the discrete choices are the same. The CPU tests
(tests/test_torch_diff.py), the card's tests (tests/test_torch_cuda.py)
and chip_smoke.py run them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

# (env mode name, parameter path, flat index, rtol) of the reference's FD
# checks: the red albedo, the lamp's green emission, the background's blue,
# the sun intensity, the mirror's fuzz.
FD_CHECKS = (
    ("SOLID_COLOR", "scene.materials.albedo", 0, 0.08),
    ("SOLID_COLOR", "scene.materials.albedo", 2 * 3 + 1, 0.08),
    ("SOLID_COLOR", "env.background_color", 2, 0.08),
    ("PHYSICAL_SUN", "env.sun_intensity", 0, 0.08),
    ("SOLID_COLOR", "scene.materials.param", 3, 0.15),
)


def tiny_state(env_mode: int):
    """(RenderState, RenderConfig) of the reference's _tiny_state."""
    from ..diff import RenderState
    from ..models import camera, environment
    from ..models.scene import SceneBuilder
    from ..ops import integrator

    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    lamp = b.materials.diffuse_light("lamp", (4.0, 4.0, 4.0))
    metal = b.materials.metal("mirror", (0.9, 0.9, 0.9), fuzz=0.1)
    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, red)
    b.geometry.add_sphere((0.0, -100.0, 0.0), 100.0, gray)
    b.geometry.add_sphere((2.2, 1.0, -1.0), 0.7, metal)
    b.geometry.add_sphere((-2.0, 2.5, 1.0), 0.5, lamp)
    scene = b.build(with_bvh=False)
    cam = camera.make_camera(image_width=24, image_height=16, vfov=40.0,
                             lookfrom=(0.0, 2.0, 8.0), lookat=(0.0, 1.0, 0.0),
                             defocus_angle=0.0)
    env = environment.make_environment(background_color=(0.3, 0.5, 0.9),
                                       sun_direction=(0.4, 0.8, 0.2),
                                       sun_intensity=4.0)
    cfg = integrator.RenderConfig(width=24, height=16, samples_per_pixel=2,
                                  max_depth=4, env_mode=env_mode,
                                  use_albedo=False, use_normal=False,
                                  use_z_depth=False)
    return RenderState(scene=scene, cam=cam, env=env), cfg


def fd_check(state, cfg, seed, path: str, index: int, *, device,
             eps: float = 1e-3):
    """(autograd, central finite difference) of the L2 loss against a
    black target at params[path].flatten()[index], both on `device`."""
    from ..diff import finite_difference_grad, make_loss_fn

    state = state.to(device)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)
    loss_fn, params = make_loss_fn(state, cfg, target, [path], device=device)
    leaf = params[path].detach().clone().requires_grad_(True)
    loss = loss_fn({path: leaf}, seed)
    # A loss that no path connects to the leaf has a zero gradient.
    grad = (torch.autograd.grad(loss, leaf, allow_unused=True)[0]
            if loss.requires_grad else None)
    g = 0.0 if grad is None else float(grad.reshape(-1)[index])
    fd = finite_difference_grad(loss_fn, params, path, index, seed, eps=eps)
    return g, fd


def fd_agrees(g: float, fd: float, rtol: float) -> bool:
    """The reference's rule: both below 1e-6 in magnitude, or
    |g - fd| <= 1e-5 + rtol |fd|."""
    if not (np.isfinite(g) and np.isfinite(fd)):
        return False
    if abs(fd) < 1e-6 and abs(g) < 1e-6:
        return True
    return abs(g - fd) <= 1e-5 + rtol * abs(fd)


def search_agreement(a: list, b: list, n_pixels: int):
    """Where two recordings of one chunked render's closest-hit searches
    agree: a and b list the Hits of its searches in order. Lane slot i of
    every search renders pixel i % n_pixels. Returns (lanes bool[L]: the
    slot's hit, primitive type and index agree on every search; pixels
    bool[n_pixels]: every slot of the pixel agrees). A search that only one
    recording made counts its hit lanes as differing."""
    agree = torch.ones(a[0].hit.shape[0], dtype=torch.bool)
    for x, y in itertools.zip_longest(a, b):
        if x is None or y is None:
            agree &= ~(x or y).hit.cpu()
            continue
        x, y = (type(h)(*(v.cpu() for v in h)) for h in (x, y))
        agree &= (x.hit == y.hit) & (~x.hit | ((x.prim_type == y.prim_type)
                                               & (x.prim_idx == y.prim_idx)))
    return agree, agree.reshape(-1, n_pixels).all(0)
