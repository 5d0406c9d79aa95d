"""HDR post-processing chain (twin of raytracer_project_tpu/ops/post.py):
the reference's post_processor (color_processing.hpp:43-345), bloom filter
(bloom.hpp:6-70) and buffer-level pipeline (camera.hpp:142-207).

Every function is plain torch ops over an [H, W, 3] image on any device,
differentiable through autograd, so gradients flow from final pixels into
the radiance buffers and the grade parameters. As in the reference, the
beauty pass takes exposure twice: a 2^exposure multiply before bloom and
sharpening (camera.hpp:160-166) and a linear `* exposure` inside `process`
(color_processing.hpp:90). The hard histogram is not differentiable;
`soft_histogram` is the smooth stand-in.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import colorspace, vecmath
from ..core.tree import unflatten

# Render-pass ids (common.hpp:110-118).
PASS_RGB = 0
PASS_DENOISE = 1
PASS_ALBEDO = 2
PASS_NORMALS = 3
PASS_REFLECTIONS = 4
PASS_REFRACTIONS = 5
PASS_Z_DEPTH = 6

_BEAUTY_PASSES = (PASS_RGB, PASS_DENOISE)
_LIGHT_PASSES = (PASS_REFLECTIONS, PASS_REFRACTIONS)


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """Post switches (color_processing.hpp:54-74) and debug views (:30-41)."""

    use_aces: bool = False
    use_auto_exposure: bool = False
    use_bloom: bool = False
    bloom_radius: int = 4
    use_sharpening: bool = False
    debug_red: bool = False
    debug_green: bool = False
    debug_blue: bool = False
    debug_luminance: bool = False
    debug_bvh: bool = False

    @property
    def debug_active(self) -> bool:
        return (self.debug_red or self.debug_green or self.debug_blue
                or self.debug_luminance or self.debug_bvh)


class PostParams(NamedTuple):
    """Grade parameters, f32 tensors (color_processing.hpp:45-75)."""

    exposure: torch.Tensor           # [] linear multiplier (default 0.5)
    saturation: torch.Tensor         # []
    contrast: torch.Tensor           # []
    hue_shift: torch.Tensor          # [] degrees in [-180, 180]
    vignette_intensity: torch.Tensor  # []
    color_balance: torch.Tensor      # [3]
    exposure_compensation_stops: torch.Tensor  # []
    target_luminance: torch.Tensor   # [] auto-exposure target (0.12)
    bloom_threshold: torch.Tensor    # []
    bloom_intensity: torch.Tensor    # []
    sharpen_amount: torch.Tensor     # []

    def to(self, device):
        return PostParams(*(x.to(device) for x in self))


def make_post_params(
    *, exposure=0.5, saturation=1.0, contrast=1.0, hue_shift=0.0,
    vignette_intensity=1.0, color_balance=(1.0, 1.0, 1.0),
    exposure_compensation_stops=0.0, target_luminance=0.12,
    bloom_threshold=1.0, bloom_intensity=0.3, sharpen_amount=0.2,
    device=None,
) -> PostParams:
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return PostParams(
        exposure=f32(exposure), saturation=f32(saturation),
        contrast=f32(contrast), hue_shift=f32(hue_shift),
        vignette_intensity=f32(vignette_intensity),
        color_balance=f32(color_balance),
        exposure_compensation_stops=f32(exposure_compensation_stops),
        target_luminance=f32(target_luminance),
        bloom_threshold=f32(bloom_threshold),
        bloom_intensity=f32(bloom_intensity),
        sharpen_amount=f32(sharpen_amount))


def post_params_from_numpy(d: dict) -> PostParams:
    """PostParams from a flat {field name: numpy array} dict (the
    reference's parameters carried across as numpy)."""
    return unflatten(PostParams, d)


# --- image statistics and auto exposure (color_processing.hpp:150-204) -------

class ImageStatistics(NamedTuple):
    average_luminance: torch.Tensor    # [] log-average, 2^mean(log2 lum)
    max_luminance: torch.Tensor        # []
    histogram: torch.Tensor            # i64[256] counts over log2 lum in [-10, 10]
    normalized_histogram: torch.Tensor  # f32[256] peak-normalized


def _partials(img):
    """(sum of log2 lum, pixel count, max lum, histogram) of one image or
    window: the reductions that compose across windows."""
    lum = vecmath.luminance(img.reshape(-1, 3))
    log_lum = torch.log2(torch.clamp(lum, min=1e-4))
    bins = torch.clamp(((log_lum + 10.0) / 20.0 * 255.0).to(torch.int32), 0, 255)
    hist = torch.bincount(bins.long(), minlength=256)
    return log_lum.sum(), log_lum.numel(), lum.max(), hist


def _statistics(total_log, count, mx, hist) -> ImageStatistics:
    peak = torch.clamp(hist.max(), min=1)
    return ImageStatistics(
        average_luminance=torch.exp2(total_log / count), max_luminance=mx,
        histogram=hist, normalized_histogram=hist.to(torch.float32) / peak)


def analyze_framebuffer(img) -> ImageStatistics:
    """Image statistics of [..., 3] (color_processing.hpp:150-182)."""
    return _statistics(*_partials(img))


def analyze_framebuffer_psum(img, group=None) -> ImageStatistics:
    """Statistics of an image held in pieces, from each piece's reductions:
    the log-average as the summed log over the summed count, the max of
    the maxima, the summed histograms (reference
    analyze_framebuffer_psum, post.py). `img` is either a list of windows
    [..., 3] (on any devices; combined on the first's), or this process's
    window, reduced with all_reduce over the torch.distributed `group`
    (the default group when None) and returned on every process."""
    if isinstance(img, (list, tuple)):
        dev = img[0].device
        parts = [_partials(w) for w in img]
        total = sum(p[0].to(dev) for p in parts)
        count = float(sum(p[1] for p in parts))
        mx = torch.stack([p[2].to(dev) for p in parts]).max()
        hist = sum(p[3].to(dev) for p in parts)
        return _statistics(total, count, mx, hist)
    import torch.distributed as dist

    total, count, mx, hist = _partials(img)
    # gloo reduces host tensors; other backends the image's device.
    dev = "cpu" if dist.get_backend(group) == "gloo" else img.device
    sums = torch.cat([torch.stack([total, torch.tensor(float(count),
                                                       device=total.device)]),
                      hist.to(total.dtype)]).to(dev, torch.float64)
    mx = mx.to(dev).reshape(1)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    out_dev = img.device
    return _statistics(sums[0].to(out_dev, torch.float32),
                       sums[1].to(out_dev, torch.float32), mx[0].to(out_dev),
                       sums[2:].round().to(out_dev, torch.int64))


def soft_histogram(img, bins: int = 256, lo: float = -10.0, hi: float = 10.0,
                   temperature: float = 0.5):
    """Differentiable log-luminance histogram by Gaussian soft binning."""
    lum = torch.log2(torch.clamp(vecmath.luminance(img.reshape(-1, 3)), min=1e-4))
    centers = torch.linspace(lo, hi, bins, device=img.device)
    width = (hi - lo) / bins
    w = torch.exp(-0.5 * ((lum[:, None] - centers[None, :])
                          / (width * temperature)) ** 2)
    return torch.sum(w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12), dim=0)


def auto_exposure(params: PostParams, stats: ImageStatistics,
                  config: PostConfig):
    """The exposure in effect (color_processing.hpp:185-204)."""
    if not config.use_auto_exposure:
        return torch.clamp(params.exposure, 0.01, 10.0)
    safe = torch.clamp(stats.average_luminance, min=0.02)
    exp = params.target_luminance / safe * torch.exp2(
        params.exposure_compensation_stops)
    return torch.clamp(exp, 0.01, 4.0)


# --- colour ops (color_processing.hpp:230-344) --------------------------------

def apply_contrast(c, contrast):
    """Pivot-0.18 linear contrast (color_processing.hpp:230-238)."""
    return torch.clamp((c - 0.18) * contrast + 0.18, min=0.0)


def rgb_to_hsv(c):
    """HSV with h in degrees (color_processing.hpp:280-308)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = c.amax(dim=-1)
    mn = c.amin(dim=-1)
    d = mx - mn
    safe_d = torch.where(d < 1e-12, 1.0, d)
    h = torch.where(
        mx == r, (g - b) / safe_d + torch.where(g < b, 6.0, 0.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d < 1e-12, 0.0, h / 6.0)
    s = torch.where(mx < 1e-6, 0.0, d / torch.clamp(mx, min=1e-12))
    return torch.stack([h * 360.0, s, mx], dim=-1)


def hsv_to_rgb(hsv):
    """The inverse of rgb_to_hsv (color_processing.hpp:310-344)."""
    h = hsv[..., 0] / 360.0
    s = hsv[..., 1]
    v = hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i6 = i.to(torch.int32) % 6

    def select(choices, default):
        out = default
        for k in reversed(range(5)):
            out = torch.where(i6 == k, choices[k], out)
        return out

    return torch.stack([select((v, q, p, p, t), v), select((t, v, v, q, p), p),
                        select((p, p, t, v, v), q)], dim=-1)


def apply_debug_view(c, config: PostConfig):
    """Channel isolation or the luminance false colour
    (color_processing.hpp:240-278)."""
    if config.debug_luminance:
        lum = vecmath.luminance(c)[..., None]
        col = lambda *v: c.new_tensor(v)
        out = col(0.1, 0.0, 0.2).expand_as(c)
        for thresh, rgb in ((0.02, (0.0, 0.0, 1.0)), (0.10, (0.0, 0.5, 0.0)),
                            (0.40, (0.5, 0.5, 0.5)), (0.70, (1.0, 1.0, 0.0)),
                            (0.95, (1.0, 0.0, 0.0))):
            out = torch.where(lum > thresh, col(*rgb), out)
        return torch.where(lum >= 1.0, col(1.0, 1.0, 1.0), out)
    if config.debug_bvh:
        return c
    return c * c.new_tensor([float(config.debug_red), float(config.debug_green),
                             float(config.debug_blue)])


def process(img, params: PostParams, config: PostConfig,
            current_pass: int = PASS_RGB):
    """The per-pixel grade of [H, W, 3] (color_processing.hpp:76-147). Data
    passes (albedo, normal, z) get clamp and gamma only unless a debug view
    is on (:78-88)."""
    h, w = img.shape[0], img.shape[1]
    if current_pass not in _BEAUTY_PASSES and not config.debug_active:
        return colorspace.linear_to_gamma(torch.clamp(img, 0.0, 1.0))
    dev = img.device
    c = img * params.exposure
    c = c * params.color_balance
    c = apply_contrast(c, params.contrast)
    # Vignette.
    uu = (torch.linspace(0.0, 1.0, w, device=dev) if w > 1
          else torch.full((1,), 0.5, device=dev))
    vv = (torch.linspace(0.0, 1.0, h, device=dev) if h > 1
          else torch.full((1,), 0.5, device=dev))
    dist = torch.sqrt((uu[None, :] - 0.5) ** 2 + (vv[:, None] - 0.5) ** 2)
    c = c * torch.clamp(1.0 - dist * params.vignette_intensity, 0.0, 1.0)[..., None]
    # Luma-preserving HSV saturation and hue shift.
    luma = vecmath.luminance(c)[..., None]
    hsv = rgb_to_hsv(c / torch.clamp(luma, min=1e-4))
    hue = torch.remainder(hsv[..., 0] + params.hue_shift, 360.0)
    hue = torch.where(hue < 0.0, hue + 360.0, hue)
    sat = torch.clamp(hsv[..., 1] * params.saturation, 0.0, 1.0)
    shifted = hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1)) * luma
    c = torch.where(luma > 1e-4, shifted, c)
    if config.use_aces:
        c = colorspace.apply_aces(c)
    if config.debug_active:
        c = apply_debug_view(c, config)
    return colorspace.linear_to_gamma(torch.clamp(c, 0.0, 1.0))


# --- bloom (bloom.hpp:6-70) and sharpening -------------------------------------

def bloom_overlay(img, params: PostParams, config: PostConfig):
    """Threshold bright pass and a separable linear-falloff blur."""
    lum = vecmath.luminance(img)[..., None]
    factor = (lum - params.bloom_threshold) * params.bloom_intensity
    bright = torch.where(lum > params.bloom_threshold,
                         img * factor / torch.clamp(lum, min=1e-4), 0.0)
    r = config.bloom_radius

    def blur(x, axis):
        # Taps past the border add neither value nor weight (bloom.hpp:59-66).
        acc = torch.zeros_like(x)
        wacc = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
        n = x.shape[axis]
        for off in range(-r, r + 1):
            wgt = float(1.0 - abs(off) / (r + 1.0))
            idx = torch.arange(n, device=x.device) + off
            ok = (idx >= 0) & (idx < n)
            ok = ok[:, None] if axis == 0 else ok[None, :]
            acc = acc + torch.where(ok[..., None], torch.roll(x, -off, axis),
                                    0.0) * wgt
            wacc = wacc + torch.where(ok, wgt, 0.0)
        return acc / torch.clamp(wacc, min=1e-12)[..., None]

    return blur(blur(bright, 1), 0)


def apply_sharpening(img, amount):
    """5-point unsharp mask on interior pixels (color_processing.hpp:207-227)."""
    sharp = (img * 5.0 - torch.roll(img, 1, 0) - torch.roll(img, -1, 0)
             - torch.roll(img, 1, 1) - torch.roll(img, -1, 1))
    out = img * (1.0 - amount) + sharp * amount
    h, w = img.shape[0], img.shape[1]
    rows = torch.arange(h, device=img.device)
    cols = torch.arange(w, device=img.device)
    interior = (((rows > 0) & (rows < h - 1))[:, None]
                & ((cols > 0) & (cols < w - 1))[None, :])
    return torch.where(interior[..., None], out, img)


def update_post_processing(img, params: PostParams, config: PostConfig,
                           current_pass: int = PASS_RGB):
    """The display/export pipeline of one pass buffer [H, W, 3]
    (camera.hpp:142-207): beauty *2^exposure -> bloom -> sharpen ->
    process; light passes process(c * 2^exposure); data passes clamp and
    gamma."""
    if current_pass in _BEAUTY_PASSES:
        c = img * torch.exp2(params.exposure)
        if config.use_bloom:
            c = c + bloom_overlay(c, params, config)
        if config.use_sharpening:
            c = apply_sharpening(c, params.sharpen_amount)
        return process(c, params, config, current_pass)
    if current_pass in _LIGHT_PASSES:
        return process(img * torch.exp2(params.exposure), params, config,
                       current_pass)
    return colorspace.linear_to_gamma(torch.clamp(img, 0.0, 1.0))
