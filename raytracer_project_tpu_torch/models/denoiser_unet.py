"""The learned denoiser: a compact residual U-Net on (beauty, albedo,
normal) (twin of raytracer_project_tpu/models/denoiser_unet.py).

It takes the reference's OIDN input contract (camera.hpp:640-648) and
predicts a residual correction of the noisy beauty in log space. The
weights are the JAX package's (raytracer_project_tpu/assets/
denoiser_weights.npz, read as a data file; HWIO kernels), carried across
by `params_from_numpy`.

Architecture: two levels, 3x3 convolutions with leaky ReLU (slope 0.1),
stride-2 downsampling, nearest upsampling with skip concatenation, ~70k
parameters. The convolutions are torch.nn.functional.conv2d (cuDNN on
the card), as the reference computes them with XLA's convolution outside
any Pallas kernel. Layout NCHW / OIHW. The reference's padding="SAME"
pads 1 on each side at stride 1, and 0 before and 1 after at stride 2 on
the even sizes the U-Net sees, so the padding is explicit. The module
computes in f32, as the reference does: it turns cuDNN's TF32 off around
its convolutions (and restores the caller's setting).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Channel widths per level.
_C0, _C1, _C2 = 24, 48, 96
_IN_CH = 9   # beauty(3) + albedo(3) + normal(3)

_LAYERS = [
    # name, (kh, kw, cin, cout), stride
    ("enc0a", (3, 3, _IN_CH, _C0), 1),
    ("enc0b", (3, 3, _C0, _C0), 1),
    ("down1", (3, 3, _C0, _C1), 2),
    ("enc1a", (3, 3, _C1, _C1), 1),
    ("down2", (3, 3, _C1, _C2), 2),
    ("bottle", (3, 3, _C2, _C2), 1),
    ("dec1a", (3, 3, _C2 + _C1, _C1), 1),
    ("dec1b", (3, 3, _C1, _C1), 1),
    ("dec0a", (3, 3, _C1 + _C0, _C0), 1),
    ("dec0b", (3, 3, _C0, _C0), 1),
    ("out", (3, 3, _C0, 3), 1),
]
_STRIDE = {name: s for name, _, s in _LAYERS}

# The JAX package's shipped weights, next to this package in the checkout.
_DEFAULT_WEIGHTS = (Path(__file__).resolve().parents[2] / "raytracer_project_tpu"
                    / "assets" / "denoiser_weights.npz")


def init_params(seed: int = 0) -> dict:
    """He-initialised parameters as numpy arrays in the reference's layout
    ({name}.w HWIO, {name}.b): the reference's init_params, value for
    value."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape, _ in _LAYERS:
        fan_in = shape[0] * shape[1] * shape[2]
        params[f"{name}.w"] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                         shape).astype(np.float32)
        params[f"{name}.b"] = np.zeros((shape[3],), np.float32)
    return params


def params_from_numpy(d) -> dict:
    """{name}.w HWIO -> OIHW f32 tensors, {name}.b as they are: the
    reference's parameters (an npz or a dict of arrays) for `apply`."""
    out = {}
    for name, _, _ in _LAYERS:
        w = np.asarray(d[f"{name}.w"], np.float32)
        out[f"{name}.w"] = torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1)))
        out[f"{name}.b"] = torch.from_numpy(np.asarray(d[f"{name}.b"],
                                                       np.float32).copy())
    return out


def param_count(params) -> int:
    return int(sum(v.numel() for v in params.values()))


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _conv(x, params, name):
    """3x3 convolution with the reference's SAME padding at the layer's
    stride: (total - total // 2) after, total // 2 before."""
    s = _STRIDE[name]
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), params[f"{name}.w"], params[f"{name}.b"],
                    stride=s)


def _upsample2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def apply(params: dict, beauty, albedo, normal):
    """Denoise [H, W, 3] buffers -> [H, W, 3] with OIHW `params`. Any size:
    the inputs are padded (edge) to a multiple of 4 for the two
    downsamplings. The network sees log1p(beauty) and predicts a residual
    there, so the output's brightness is anchored to the input's."""
    h, w = beauty.shape[0], beauty.shape[1]
    ph, pw = (-h) % 4, (-w) % 4

    def pad(img):
        return F.pad(img.permute(2, 0, 1)[None], (0, pw, 0, ph),
                     mode="replicate")

    lb = torch.log1p(torch.clamp(pad(beauty), min=0.0))
    x = torch.cat([lb, pad(albedo), pad(normal)], dim=1)

    def cv(name, t):
        return F.leaky_relu(_conv(t, params, name), 0.1)

    with _no_tf32():
        e0 = cv("enc0b", cv("enc0a", x))
        e1 = cv("enc1a", cv("down1", e0))
        b = cv("bottle", cv("down2", e1))
        d1 = cv("dec1b", cv("dec1a", torch.cat([_upsample2(b), e1], dim=1)))
        d0 = cv("dec0b", cv("dec0a", torch.cat([_upsample2(d1), e0], dim=1)))
        res = _conv(d0, params, "out")
    out = torch.expm1(torch.clamp(lb + res, min=0.0))
    return out[0, :, :h, :w].permute(1, 2, 0)


class DenoiserUNet(nn.Module):
    """The U-Net as a module: its parameters are `params_from_numpy`'s
    tensors (He-initialised from `seed` when none are given); calling it
    on (beauty, albedo, normal) [H, W, 3] runs `apply`."""

    def __init__(self, params: dict | None = None, seed: int = 0):
        super().__init__()
        if params is None:
            params = params_from_numpy(init_params(seed))
        self.weights = nn.ParameterDict(
            {k.replace(".", "_"): nn.Parameter(v.clone()) for k, v in params.items()})

    def params(self) -> dict:
        return {k.replace("_", "."): v for k, v in self.weights.items()}

    def forward(self, beauty, albedo, normal):
        return apply(self.params(), beauty, albedo, normal)


def load_default(device=None) -> DenoiserUNet | None:
    """The U-Net with the weights at $RAYTRACER_TPU_DENOISER, else the
    repository's shipped ones, on `device` (the card unless the caller
    asks for the CPU); None when the file does not exist."""
    from ..ops.integrator import resolve_device

    path = os.environ.get("RAYTRACER_TPU_DENOISER", str(_DEFAULT_WEIGHTS))
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        params = params_from_numpy(data)
    return DenoiserUNet(params).to(resolve_device(device))
