"""Inverse rendering: select parameters by path, differentiate, optimize
(twin of raytracer_project_tpu/diff/inverse.py).

Typical use:

    state = RenderState(scene=scene, cam=cam, env=env)
    paths = ["scene.materials.albedo", "env.sun_intensity"]
    fitted, losses = fit(state, seed, config, target, paths, steps=200)

Every step renders with the same seed (a frozen sample pattern), so the
loss surface is a deterministic function and central finite differences
agree with autograd (tests/test_torch_diff.py). resample_keys=True folds
the step index into the seed's key instead, as the reference's
jax.random.fold_in does, bit for bit (stochastic descent over sample
patterns).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..core import rng
from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models.scene import Scene
from ..ops import integrator


class RenderState(NamedTuple):
    """Everything a render differentiates through."""

    scene: Scene
    cam: camera_mod.Camera
    env: env_mod.Environment

    def to(self, device):
        return RenderState(*(x.to(device) for x in self))


# --- dotted-path access into nested NamedTuples -------------------------------

def tree_get(root: Any, path: str):
    """The leaf or subtree at a dotted path, e.g. "scene.materials.albedo"."""
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def tree_set(root: Any, path: str, value: Any):
    """`root` with the leaf at `path` replaced (a NamedTuple _replace chain)."""
    head, _, rest = path.partition(".")
    if not rest:
        return root._replace(**{head: value})
    return root._replace(**{head: tree_set(getattr(root, head), rest, value)})


def extract_params(state: RenderState, paths: Sequence[str]) -> dict:
    """{path: leaf} of the selected parameters."""
    return {p: tree_get(state, p) for p in paths}


def apply_params(state: RenderState, params: dict) -> RenderState:
    """The state with {path: leaf} written in."""
    for p, v in params.items():
        state = tree_set(state, p, v)
    return state


# --- the differentiable forward and the losses --------------------------------

def render_beauty(state: RenderState, seed, config: integrator.RenderConfig, *,
                  device=None):
    """Beauty image f32[H, W, 3], differentiable in every tensor of the
    state. Forces config.differentiable=True (the chunked engine with the
    detached search). device as integrator.render: the card by default."""
    if not config.differentiable:
        config = dataclasses.replace(config, differentiable=True)
    out = integrator.render(state.scene, state.cam, state.env, seed, config,
                            device=device)
    return out["beauty"]


def image_loss(rendered, target, kind: str = "l2"):
    """Scalar image loss: "l2" (MSE), "l1", or "relative", MSE over
    (rendered^2 + 1e-2) with the denominator detached (the Mitsuba-style
    relative loss, robust to HDR range)."""
    diff = rendered - target
    if kind == "l2":
        return torch.mean(diff * diff)
    if kind == "l1":
        return torch.mean(torch.abs(diff))
    if kind == "relative":
        return torch.mean(diff * diff / (rendered.detach() ** 2 + 1e-2))
    raise ValueError(f"unknown loss kind: {kind}")


def make_loss_fn(state: RenderState, config: integrator.RenderConfig, target,
                 paths: Sequence[str], loss_kind: str = "l2", *, device=None):
    """(loss_fn(params, seed) -> scalar tensor, the initial params dict)."""
    params0 = extract_params(state, paths)

    def loss_fn(params, seed):
        img = render_beauty(apply_params(state, params), seed, config,
                            device=device)
        return image_loss(img, target, loss_kind)

    return loss_fn, params0


# --- the fit loop ----------------------------------------------------------------

def fit(state: RenderState, seed, config: integrator.RenderConfig, target,
        paths: Sequence[str], *, steps: int = 100,
        learning_rate: float = 2e-2, optimizer=None, loss_kind: str = "l2",
        project: Callable[[dict], dict] | None = None,
        resample_keys: bool = False,
        callback: Callable[[int, float], None] | None = None, device=None):
    """Gradient descent of the selected parameters toward the target image.

    The parameters are leaf tensors with requires_grad on the render's
    device (the card unless device says otherwise). optimizer: a factory
    taking the list of leaves and returning a torch optimizer; the default
    torch.optim.Adam(lr=learning_rate) is optax.adam's update (b1 0.9, b2
    0.999, eps 1e-8, bias-corrected). project: a map of the params dict to
    constrained values (e.g. albedo clipped to [0, 1]), applied after each
    step under no_grad. seed: an integer (PRNGKey(seed)) or an rng.Key;
    resample_keys renders step i with fold_in(key, i). Returns
    (fitted state, losses), each loss the one before its step's update."""
    dev = integrator.resolve_device(device)
    state = state.to(dev)
    target = torch.as_tensor(target).to(dev)
    params = {p: tree_get(state, p).detach().clone().requires_grad_(True)
              for p in paths}
    if optimizer is None:
        optimizer = lambda leaves: torch.optim.Adam(leaves, lr=learning_rate)
    opt = optimizer(list(params.values()))
    loss_fn, _ = make_loss_fn(state, config, target, paths, loss_kind,
                              device=dev)
    key = seed if isinstance(seed, rng.Key) else rng.Key(0, int(seed))

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, rng.fold_in(key, i) if resample_keys else seed)
        if loss.requires_grad:   # else no parameter reaches the image
            loss.backward()
        opt.step()
        if project is not None:
            with torch.no_grad():
                for p, v in project(params).items():
                    params[p].copy_(v)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1])
    return apply_params(state, {p: v.detach() for p, v in params.items()}), losses


def finite_difference_grad(loss_fn, params: dict, path: str, index: int, seed,
                           eps: float = 1e-3) -> float:
    """Central finite difference of loss_fn at params[path].flatten()[index]:
    the gradient-parity oracle of autograd."""
    leaf = params[path].detach()

    def eval_at(delta):
        flat = leaf.reshape(-1).clone()
        flat[index] += delta
        with torch.no_grad():
            return float(loss_fn(dict(params, **{path: flat.reshape(leaf.shape)}),
                                 seed))

    return (eval_at(eps) - eval_at(-eps)) / (2.0 * eps)
