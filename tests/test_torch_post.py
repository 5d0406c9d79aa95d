"""The port's post chain and colour space (ops/post.py, core/colorspace.py)
against the reference's on the same numpy images, the statistics of an
image held in windows, and gradients through the chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_project_tpu.core import colorspace as jcs
from raytracer_project_tpu.ops import post as jpost
from raytracer_project_tpu_torch.core import colorspace as tcs
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.ops import post as tpost

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _image(h=19, w=23, seed=0):
    """An HDR image with dark, mid, bright and a few non-finite values."""
    rng = np.random.default_rng(seed)
    img = (rng.lognormal(-1.0, 1.5, size=(h, w, 3))).astype(np.float32)
    img[0, :4] = 0.0
    img[3, 5] = 40.0
    return img


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach")
                                          else a),
                               np.asarray(b), **(tol or TOL))


PARAM_KW = dict(exposure=0.7, saturation=1.3, contrast=1.2, hue_shift=25.0,
                vignette_intensity=0.8, color_balance=(1.1, 0.95, 0.9),
                exposure_compensation_stops=0.5, target_luminance=0.15,
                bloom_threshold=0.8, bloom_intensity=0.4, sharpen_amount=0.3)


@pytest.fixture(scope="module")
def params():
    jp = jpost.make_post_params(**PARAM_KW)
    tp = tpost.post_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()})
    return jp, tp


def test_params_from_numpy(params):
    jp, tp = params
    ref = {k: np.asarray(v) for k, v in jp._asdict().items()}
    for k, v in flatten(tpost.make_post_params(**PARAM_KW)).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    for k, v in flatten(tp).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["scrub_non_finite", "apply_aces",
                                  "linear_to_gamma", "gamma_to_linear",
                                  "to_srgb_u8"])
def test_colorspace(name):
    img = _image()
    img[1, 1] = (np.nan, np.inf, -np.inf)
    if name not in ("scrub_non_finite", "apply_aces", "to_srgb_u8"):
        img = np.nan_to_num(img, posinf=0.0, neginf=0.0) - 0.1
    ref = getattr(jcs, name)(jnp.asarray(img))
    out = getattr(tcs, name)(torch.as_tensor(img))
    if name == "to_srgb_u8":
        assert out.dtype == torch.uint8
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    else:
        _close(out, ref)


def test_analyze_framebuffer():
    img = _image()
    ref = jpost.analyze_framebuffer(jnp.asarray(img))
    out = tpost.analyze_framebuffer(torch.as_tensor(img))
    _close(out.average_luminance, ref.average_luminance)
    _close(out.max_luminance, ref.max_luminance)
    np.testing.assert_array_equal(out.histogram.numpy(), np.asarray(ref.histogram))
    _close(out.normalized_histogram, ref.normalized_histogram)


def test_analyze_framebuffer_psum_over_windows():
    """Windows of unequal sizes combine to the whole image's statistics."""
    flat = torch.as_tensor(_image()).reshape(-1, 3)
    whole = tpost.analyze_framebuffer(flat)
    parts = tpost.analyze_framebuffer_psum([flat[:100], flat[100:101],
                                            flat[101:]])
    _close(parts.average_luminance, whole.average_luminance)
    assert float(parts.max_luminance) == float(whole.max_luminance)
    assert torch.equal(parts.histogram, whole.histogram)


def test_soft_histogram_and_auto_exposure(params):
    jp, tp = params
    img = _image()
    # Each bin sums 437 soft weights, in another order than XLA's.
    _close(tpost.soft_histogram(torch.as_tensor(img)),
           jpost.soft_histogram(jnp.asarray(img)), rtol=1e-4, atol=1e-4)
    jstats = jpost.analyze_framebuffer(jnp.asarray(img))
    tstats = tpost.analyze_framebuffer(torch.as_tensor(img))
    for auto in (False, True):
        cfg_j = jpost.PostConfig(use_auto_exposure=auto)
        cfg_t = tpost.PostConfig(use_auto_exposure=auto)
        _close(tpost.auto_exposure(tp, tstats, cfg_t),
               jpost.auto_exposure(jp, jstats, cfg_j))


def test_colour_ops():
    img = _image()
    c = np.clip(img, 0.0, 4.0)
    _close(tpost.apply_contrast(torch.as_tensor(c), 1.3),
           jpost.apply_contrast(jnp.asarray(c), 1.3))
    hsv_j = jpost.rgb_to_hsv(jnp.asarray(c))
    hsv_t = tpost.rgb_to_hsv(torch.as_tensor(c))
    # Hue is in degrees: a few ulp of its quotient near 0 exceed atol 1e-6.
    _close(hsv_t, hsv_j, rtol=1e-5, atol=1e-5)
    _close(tpost.hsv_to_rgb(torch.as_tensor(np.array(hsv_j))),
           jpost.hsv_to_rgb(hsv_j))
    for kw in (dict(debug_red=True), dict(debug_green=True, debug_blue=True),
               dict(debug_luminance=True), dict(debug_bvh=True)):
        _close(tpost.apply_debug_view(torch.as_tensor(c), tpost.PostConfig(**kw)),
               jpost.apply_debug_view(jnp.asarray(c), jpost.PostConfig(**kw)))


def test_bloom_and_sharpening(params):
    jp, tp = params
    img = _image()
    for r in (1, 4):
        _close(tpost.bloom_overlay(torch.as_tensor(img), tp,
                                   tpost.PostConfig(bloom_radius=r)),
               jpost.bloom_overlay(jnp.asarray(img), jp,
                                   jpost.PostConfig(bloom_radius=r)))
    _close(tpost.apply_sharpening(torch.as_tensor(img), tp.sharpen_amount),
           jpost.apply_sharpening(jnp.asarray(img), jp.sharpen_amount))


CONFIGS = [dict(), dict(use_aces=True), dict(use_bloom=True, use_sharpening=True),
           dict(use_aces=True, use_bloom=True, use_sharpening=True,
                bloom_radius=2), dict(debug_luminance=True)]
PASSES = [tpost.PASS_RGB, tpost.PASS_ALBEDO, tpost.PASS_REFLECTIONS]


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("current_pass", PASSES)
def test_update_post_processing(params, cfg, current_pass):
    jp, tp = params
    img = _image()
    out = tpost.update_post_processing(torch.as_tensor(img), tp,
                                       tpost.PostConfig(**cfg), current_pass)
    ref = jpost.update_post_processing(jnp.asarray(img), jp,
                                       jpost.PostConfig(**cfg), current_pass)
    # Gamma's slope near 0 (x^(1/2.2)) turns an ulp of a dark bloomed
    # pixel into a few 1e-6 of output: atol 3e-6.
    _close(out, ref, rtol=1e-5, atol=3e-6)
    _close(tpost.process(torch.as_tensor(img), tp, tpost.PostConfig(**cfg),
                         current_pass),
           jpost.process(jnp.asarray(img), jp, jpost.PostConfig(**cfg),
                         current_pass))


def test_gradients_are_finite(params):
    """Gradients reach the image and every grade parameter through the
    whole chain (bloom, sharpening, ACES), finite."""
    _, tp = params
    img = torch.as_tensor(_image()).requires_grad_(True)
    leaves = tpost.PostParams(*(x.clone().requires_grad_(True) for x in tp))
    cfg = tpost.PostConfig(use_aces=True, use_bloom=True, use_sharpening=True)
    out = tpost.update_post_processing(img, leaves, cfg)
    (out.mean() + tpost.soft_histogram(img).std()).backward()
    assert torch.isfinite(img.grad).all() and img.grad.abs().sum() > 0
    for name in ("exposure", "saturation", "contrast", "color_balance",
                 "bloom_intensity", "sharpen_amount", "vignette_intensity"):
        g = getattr(leaves, name).grad
        assert g is not None and torch.isfinite(g).all(), name
