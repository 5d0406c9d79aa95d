"""Denoisers of rendered buffers (twin of
raytracer_project_tpu/ops/denoise.py): the edge-avoiding a-trous wavelet
filter, and the dispatch to a learned model (models/denoiser_unet.py).

They replace the reference's Intel OIDN stage (camera.hpp:581-699), with
its input contract: noisy beauty plus the albedo and normal guide buffers
(camera.hpp:640-648). Torch ops on [H, W, 3] tensors of any device,
differentiable; non-finite values are scrubbed first (camera.hpp:601-606).
"""

from __future__ import annotations

import torch

from ..core import colorspace


def _shift(img, dy: int, dx: int):
    """[H, W, C] shifted by (dy, dx), clamped to the edge."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


# The 5-tap B3-spline kernel of the a-trous scheme.
_KERNEL_1D = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def atrous_denoise(beauty, albedo=None, normal=None, *, iterations: int = 3,
                   sigma_color: float = 0.35, sigma_albedo: float = 0.25,
                   sigma_normal: float = 0.35):
    """Edge-avoiding a-trous wavelet filter (Dammertz et al. 2010) of the
    beauty [H, W, 3]: `iterations` passes of the 5x5 B3 taps at spacing
    2^i, each tap weighted by its colour distance and by the distances of
    the albedo and normal guides (either may be None), which stop the blur
    at material and geometric edges."""
    c = colorspace.scrub_non_finite(beauty)
    guides = [(colorspace.scrub_non_finite(g), s)
              for g, s in ((albedo, sigma_albedo), (normal, sigma_normal))
              if g is not None]
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(c)
        wacc = torch.zeros(c.shape[:2], dtype=c.dtype, device=c.device)
        for iy, wy in enumerate(_KERNEL_1D):
            for ix, wx in enumerate(_KERNEL_1D):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                c_s = _shift(c, dy, dx)
                wt = (wy * wx) * torch.exp(
                    -((c - c_s) ** 2).sum(-1) / (sigma_color ** 2))
                for g, sg in guides:
                    gd2 = ((g - _shift(g, dy, dx)) ** 2).sum(-1)
                    wt = wt * torch.exp(-gd2 / (sg ** 2))
                acc = acc + c_s * wt[..., None]
                wacc = wacc + wt
        c = acc / torch.clamp(wacc, min=1e-12)[..., None]
    return c


def denoise(beauty, albedo=None, normal=None, model=None, **kwargs):
    """The learned model when one is given (any callable (beauty, albedo,
    normal) -> image, such as denoiser_unet.load_default()), else the
    a-trous filter with **kwargs."""
    if model is not None:
        return model(beauty, albedo, normal)
    return atrous_denoise(beauty, albedo, normal, **kwargs)
