"""The port's denoisers and image metrics on the CPU, against the reference
package: the a-trous filter with and without guides, the U-Net with the
shipped weights (odd and even sizes, so both the edge padding and the
stride-2 SAME padding are exercised), its initialisation and parameter
layout, the weights' lookup, PSNR and SSIM, and gradients through the
filter."""

import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import denoiser_unet as junet
from raytracer_project_tpu.ops import denoise as jden
from raytracer_project_tpu.utils import metrics as jmet
from raytracer_project_tpu_torch.models import denoiser_unet as tunet
from raytracer_project_tpu_torch.ops import denoise as tden
from raytracer_project_tpu_torch.utils import metrics as tmet

torch.set_num_threads(2)


def _buffers(h, w, seed=0):
    """Seeded noisy beauty (HDR-ish, with a NaN and an inf), albedo, normal."""
    r = np.random.default_rng(seed)
    beauty = r.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    beauty[3, 4, 1], beauty[5, 6, 0] = np.nan, np.inf
    albedo = r.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    normal = r.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    return beauty, albedo, normal


@pytest.mark.parametrize("guides", ["none", "albedo", "both"])
def test_atrous_matches_reference(guides):
    """atrous_denoise on 37x53 buffers against the reference's (non-finite
    values scrubbed first): max |d| <= 1e-5 (f32 sums of 25 taps, 3
    passes)."""
    b, a, n = _buffers(37, 53)
    kw = {"none": {}, "albedo": {"albedo": a}, "both": {"albedo": a, "normal": n}}[guides]
    ref = np.asarray(jden.atrous_denoise(b, **kw))
    out = tden.atrous_denoise(torch.from_numpy(b),
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # The dispatch without a model is the filter.
    torch.testing.assert_close(
        tden.denoise(torch.from_numpy(b),
                     **{k: torch.from_numpy(v) for k, v in kw.items()}), out)


@pytest.fixture(scope="module")
def shipped():
    """The reference's shipped weights (jnp) and the port's U-Net on them."""
    jparams = junet.load_params(junet._DEFAULT_WEIGHTS)
    return jparams, tunet.load_default(device="cpu")


@pytest.mark.parametrize("hw", [(37, 53), (36, 52)])
def test_unet_matches_reference(shipped, hw):
    """The U-Net with the shipped weights against the reference's apply:
    37x53 (edge padding to 40x56) and 36x52 (the stride-2 layers' SAME
    padding 0 before, 1 after); max |d| <= 2e-5 relative to the output's
    largest value (f32 convolutions summed in other orders)."""
    jparams, model = shipped
    b, a, n = _buffers(*hw, seed=1)
    b = np.nan_to_num(b, posinf=0.0)
    ref = np.asarray(junet.apply(jparams, b, a, n))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (b, a, n)))
        via = tden.denoise(*map(torch.from_numpy, (b, a, n)), model=model)
    assert out.shape == hw + (3,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=2e-5 * float(np.abs(ref).max()))
    torch.testing.assert_close(via, out)


def test_unet_init_and_layout():
    """init_params(seed) equals the reference's value for value (numpy He
    init, HWIO); params_from_numpy gives OIHW weights and the biases as
    they are; the module's parameters are those tensors."""
    for seed in (0, 5):
        mine, ref = tunet.init_params(seed), junet.init_params(seed)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    p = tunet.params_from_numpy(tunet.init_params(0))
    for name, (kh, kw, cin, cout), _ in tunet._LAYERS:
        assert p[f"{name}.w"].shape == (cout, cin, kh, kw)
        assert p[f"{name}.b"].shape == (cout,)
    np.testing.assert_array_equal(
        p["down1.w"].numpy(), tunet.init_params(0)["down1.w"].transpose(3, 2, 0, 1))
    m = tunet.DenoiserUNet(seed=0)
    assert tunet.param_count(m.params()) == junet.param_count(junet.init_params(0))
    torch.testing.assert_close(m.params()["out.w"], p["out.w"])


def test_load_default(monkeypatch, tmp_path):
    """load_default reads $RAYTRACER_TPU_DENOISER, else the repository's
    weights, and returns None when the file does not exist; it runs on the
    card unless asked for the CPU."""
    monkeypatch.delenv("RAYTRACER_TPU_DENOISER", raising=False)
    shipped = tunet.load_default(device="cpu")
    assert isinstance(shipped, tunet.DenoiserUNet)
    with np.load(tunet._DEFAULT_WEIGHTS) as d:
        np.testing.assert_array_equal(shipped.params()["enc0a.w"].detach().numpy(),
                                      d["enc0a.w"].transpose(3, 2, 0, 1))
    path = tmp_path / "w.npz"
    np.savez(path, **tunet.init_params(3))
    monkeypatch.setenv("RAYTRACER_TPU_DENOISER", str(path))
    mine = tunet.load_default(device="cpu")
    torch.testing.assert_close(
        mine.params()["bottle.w"],
        tunet.params_from_numpy(tunet.init_params(3))["bottle.w"])
    monkeypatch.setenv("RAYTRACER_TPU_DENOISER", str(tmp_path / "absent.npz"))
    assert tunet.load_default(device="cpu") is None
    if not torch.cuda.is_available():
        monkeypatch.setenv("RAYTRACER_TPU_DENOISER", str(path))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tunet.load_default()


@pytest.mark.parametrize("peak", [None, 1.0])
def test_psnr_ssim_match_reference(peak):
    """psnr and ssim against the reference's on seeded 37x53 images (rtol
    1e-5), and the identities: SSIM of an image with itself is 1."""
    r = np.random.default_rng(2)
    ref = r.uniform(0.0, 1.0, (37, 53, 3)).astype(np.float32)
    img = (ref + r.normal(0.0, 0.05, ref.shape)).astype(np.float32)
    np.testing.assert_allclose(float(tmet.psnr(img, ref, peak=peak)),
                               float(jmet.psnr(img, ref, peak=peak)), rtol=1e-5)
    np.testing.assert_allclose(float(tmet.ssim(img, ref, peak=peak)),
                               float(jmet.ssim(img, ref, peak=peak)), rtol=1e-5)
    np.testing.assert_allclose(float(tmet.ssim(ref, ref, peak=peak)), 1.0,
                               rtol=1e-6)


def test_atrous_gradients_finite():
    """The a-trous filter is differentiable: finite, non-zero gradients of
    a loss of its output into the beauty and both guides, non-finite input
    values included (scrubbed before filtering)."""
    b, a, n = (torch.from_numpy(x).requires_grad_(True) for x in _buffers(19, 23))
    out = tden.atrous_denoise(b, a, n)
    gb, ga, gn = torch.autograd.grad((out ** 2).mean(), (b, a, n))
    for g in (gb, ga, gn):
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    assert float(gb[3, 4, 1]) == 0.0   # the scrubbed NaN takes no gradient
