"""Differentiable rendering and the inverse fit (twin of
raytracer_project_tpu/diff/).

The scene, camera and environment are NamedTuples of tensors, and the
chunked integrator with differentiable=True is torch ops around a
detached closest-hit search, so autograd carries the gradient of an image
loss to any of their tensors (material albedo, emission, sun direction,
HDR texels, sphere centres, the camera frame). This package adds
dotted-path parameter selection, the losses and an Adam fit loop.

Gradient semantics (detached sampling): the discrete choices (which
primitive a ray hits, BVH branches, Russian-roulette kills, the dielectric
reflect-or-refract draw) are piecewise constant in the parameters, so
their derivative terms (visibility, silhouettes) are left out; gradients
flow through the continuous shading, the geometry at fixed visibility and
the environment.
"""

from .inverse import (
    RenderState,
    apply_params,
    extract_params,
    finite_difference_grad,
    fit,
    image_loss,
    make_loss_fn,
    render_beauty,
    tree_get,
    tree_set,
)

__all__ = [
    "RenderState",
    "apply_params",
    "extract_params",
    "finite_difference_grad",
    "fit",
    "image_loss",
    "make_loss_fn",
    "render_beauty",
    "tree_get",
    "tree_set",
]
