"""Image-quality metrics: PSNR and SSIM (twin of
raytracer_project_tpu/utils/metrics.py).

They measure the denoisers against high-spp references (the evidence
behind the reference's OIDN sample-reduction claim, README.md:556-561).
Both take linear-RGB [H, W, 3] float images (tensors or arrays) and return
0-d f32 tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def psnr(img, ref, *, peak: float | None = None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB. peak defaults to the reference
    image's max (HDR-friendly); pass 1.0 for tone-mapped [0, 1] images."""
    img = _f32(img)
    ref = _f32(ref).to(img.device)
    if peak is None:
        peak = torch.clamp(ref.max(), min=1e-8)
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-20))


def _box_filter(x, radius: int):
    """Mean over a (2 radius + 1)^2 window, clamp-to-edge; x is [H, W, C].
    Separable running sums, as the reference computes them."""
    k = 2 * radius + 1
    out = F.pad(x.permute(2, 0, 1)[None], (radius,) * 4,
                mode="replicate")[0].permute(1, 2, 0)
    for axis in (0, 1):
        c = torch.cumsum(out, dim=axis)
        c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
        n = c.shape[axis]
        out = (c.narrow(axis, k, n - k) - c.narrow(axis, 0, n - k)) / k
    return out


def ssim(img, ref, *, peak: float | None = None, radius: int = 3,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity (Wang et al. 2004) over a box window; in
    [-1, 1], 1.0 for identical images."""
    x = _f32(img)
    y = _f32(ref).to(x.device)
    if peak is None:
        peak = torch.clamp(y.max(), min=1e-8)
    c1 = (k1 * peak) ** 2
    c2 = (k2 * peak) ** 2
    mu_x = _box_filter(x, radius)
    mu_y = _box_filter(y, radius)
    xx = _box_filter(x * x, radius) - mu_x * mu_x
    yy = _box_filter(y * y, radius) - mu_y * mu_y
    xy = _box_filter(x * y, radius) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (xx + yy + c2)
    return torch.mean(num / den)
