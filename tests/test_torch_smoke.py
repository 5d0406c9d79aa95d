"""The port's smoke gate (raytracer_project_tpu_torch/utils/smoke.py), its
golden tools and the last tool twins on the CPU: `_check_image` against
the JAX package's verdicts on the same arrays, the card's branch of the
two-golden policy through a made-up device, the fast smoke and hit-agree
stages, the module without a card, make_device_goldens' interlocks, the
writers' refusal of the reference's directories, prof_fused_step and the
parity gallery at a tiny size."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_project_tpu.utils import smoke as jsmoke
from raytracer_project_tpu_torch.tools import goldens
from raytracer_project_tpu_torch.tools import make_device_goldens as mdg
from raytracer_project_tpu_torch.tools import make_goldens
from raytracer_project_tpu_torch.tools import make_parity_gallery as gallery
from raytracer_project_tpu_torch.tools import make_smoke_goldens
from raytracer_project_tpu_torch.tools import prof_fused_step
from raytracer_project_tpu_torch.utils import image_io, smoke

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NAME = "smoke_fused_64x36"
CARD = smoke.DeviceInfo("cuda", "Made-up Card 80GB", "12.8")


def _golden():
    return np.load(smoke._golden_path(NAME))["beauty"]


def _speckle(img, frac, seed=0):
    """img with `frac` of its pixels brightened by 0.3 in every channel."""
    r = np.random.default_rng(seed)
    out = img.copy()
    hit = r.random(img.shape[:2]) < frac
    out[hit] += 0.3
    return out


CASES = {
    "golden": (lambda g: g, True),
    "sparse_speckle": (lambda g: _speckle(g, 0.005), True),
    "dense_speckle": (lambda g: _speckle(g, 0.03), False),
    "half": (lambda g: 0.5 * g, False),
    "nan": (lambda g: np.where(np.arange(g.size).reshape(g.shape) == 7,
                               np.float32(np.nan), g), False),
    "black": (lambda g: np.zeros_like(g), False),
    "shape": (lambda g: np.ascontiguousarray(g[:, :32]), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_image_gives_the_reference_verdict(case):
    """The same arrays through both packages' _check_image on the CPU: the
    same verdict, word for word (budgets mean |d| <= 0.01, frac(>0.05)
    <= 0.01)."""
    make, ok = CASES[case]
    img = make(_golden()).astype(np.float32)
    ref = jsmoke._check_image(img, NAME, "stage", max_frac=0.01)
    mine = smoke._check_image(img, NAME, "stage", max_frac=0.01)
    assert mine == ref
    assert (mine is None) == ok, mine


def _device_golden(tmp_path, img, info=CARD):
    assert mdg.write_goldens([[(NAME, "fused-fast", 0.01, img)]] * 2,
                             tmp_path, info) == 0
    return tmp_path


def test_card_branch_tight_check(tmp_path, capsys):
    """A device golden of the same card and CUDA version: the render it
    was made from passes with a logged device-golden diff; a drift of 2e-5
    in every value (statistically invisible) fails the tight check."""
    g = _golden()
    d = _device_golden(tmp_path, g)
    assert smoke._check_image(g, NAME, "s", device=CARD, device_dir=d) is None
    assert "device-golden diff mean=0.00e+00" in capsys.readouterr().out
    err = smoke._check_image(g + 2e-5, NAME, "s", device=CARD, device_dir=d)
    assert "drifted from device golden" in err
    assert smoke._check_image(g + 2e-5, NAME, "s", device=CARD._replace(
        type="cpu")) is None


@pytest.mark.parametrize("field", ["name", "cuda"])
def test_card_branch_mismatch_skips_the_tight_check(tmp_path, capsys, field):
    """A device golden made on another card or CUDA version: the tight
    check is skipped with a logged reason, the statistical one still runs
    and still refuses a systematically wrong image."""
    g = _golden()
    d = _device_golden(tmp_path, g)
    other = CARD._replace(**{field: "other"})
    assert smoke._check_image(g + 2e-5, NAME, "s", device=other,
                              device_dir=d) is None
    log = capsys.readouterr().out
    assert "tight check skipped" in log and "CPU-golden diff" in log
    assert "device-golden diff" not in log
    assert "systematically" in smoke._check_image(0.5 * g, NAME, "s",
                                                  device=other, device_dir=d)


def test_card_branch_missing_device_golden(tmp_path, capsys):
    """No device golden: the statistical check only, logged; speckle
    within the cross-backend budgets passes, half the image does not."""
    g = _golden()
    assert smoke._check_image(_speckle(g, 0.1), NAME, "s", device=CARD,
                              device_dir=tmp_path) is None
    assert "missing — statistical CPU check only" in capsys.readouterr().out
    assert "systematically" in smoke._check_image(0.5 * g, NAME, "s",
                                                  device=CARD,
                                                  device_dir=tmp_path)


def test_device_golden_lookup():
    """Device goldens live in the port's goldens/ directory, CPU goldens in
    tests/goldens/; the five committed device goldens name their card."""
    assert smoke._golden_path(NAME) == REPO / "tests" / "goldens" / f"{NAME}.npz"
    assert smoke._golden_path(NAME + "_cuda").parent == smoke.DEVICE_GOLDEN_DIR
    names = ["smoke_fused_64x36", "smoke_pool_128x72"] + [
        f"smoke_features_{k}_64x36" for k in ("beauty", "albedo", "reflection")]
    for name in names:
        with np.load(smoke._golden_path(name + "_cuda")) as z:
            assert z["beauty"].shape == np.load(
                smoke._golden_path(name))["beauty"].shape
            assert str(z["device"]) and str(z["cuda"])


def test_fast_smoke_on_the_cpu(monkeypatch, capsys):
    """SMOKE_FAST=1 runs fused-fast alone, and it passes on the CPU."""
    monkeypatch.setenv("SMOKE_FAST", "1")
    assert smoke.run_smoke("cpu") == 0
    out = capsys.readouterr().out
    assert "SMOKE OK: device=cpu stages=['fused-fast']" in out


def test_hit_agree_on_the_cpu(capsys):
    assert smoke.stage_hit_agree("cpu") == 0
    assert "hit-agree: ok" in capsys.readouterr().out


def test_module_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    err = capsys.readouterr().err
    assert "SMOKE FAIL" in err and "no CUDA device" in err


def test_device_golden_interlocks(tmp_path):
    """make_device_goldens writes an image that passes its CPU golden and
    whose runs agree, with the card's name and CUDA version; it refuses
    (exit 1, nothing written) one that fails the cross-backend budget and
    one whose runs differ by more than 1e-6 in the mean."""
    g = _golden()
    assert mdg.write_goldens([[(NAME, "x", 0.01, 0.5 * g)]] * 3, tmp_path,
                             CARD) == 1
    assert not list(tmp_path.iterdir())
    runs = [[(NAME, "x", 0.01, g + k * 2e-6)] for k in range(3)]
    assert mdg.write_goldens(runs, tmp_path, CARD) == 1
    assert not list(tmp_path.iterdir())
    assert mdg.spread([g, g + 2e-6, g + 4e-6])[0] == pytest.approx(4e-6,
                                                                   rel=1e-2)
    assert mdg.write_goldens([[(NAME, "x", 0.01, g)]] * 3, tmp_path, CARD) == 0
    with np.load(tmp_path / f"{NAME}_cuda.npz") as z:
        assert (str(z["device"]), str(z["cuda"])) == (CARD.name, CARD.cuda)
        np.testing.assert_array_equal(z["beauty"], g)


@pytest.mark.parametrize("target", ["tests/goldens", "tests/goldens/sub",
                                    "raytracer_project_tpu/assets"])
def test_writers_refuse_the_reference(tmp_path, target):
    """The golden writers never write into tests/goldens/ or the JAX
    package; a directory they are given gets the npz."""
    path = str(REPO / target)
    for main in (make_smoke_goldens.main, make_goldens.main):
        with pytest.raises(ValueError, match="refusing"):
            main([path])
    with pytest.raises(ValueError, match="refusing"):
        mdg.write_goldens([[(NAME, "x", 0.01, _golden())]], path, CARD)
    assert not (REPO / "tests" / "goldens" / "sub").exists()
    written = goldens.write_golden(tmp_path, NAME, _golden())
    np.testing.assert_array_equal(np.load(written)["beauty"], _golden())


def test_prof_fused_step_runs_small(monkeypatch):
    monkeypatch.setattr(prof_fused_step, "TURN_CALLS", 1)
    rows = prof_fused_step.main(["--device", "cpu", "--width", "32",
                                 "--height", "18", "--spp", "2"])
    assert list(rows) == ["full body step", "K1 closest_hit_od",
                          "K3 fused + respawn", "host per turn (spans)"]
    assert all(v > 0 for v in rows.values())


def test_parity_gallery_runs_small(tmp_path):
    """The gallery's 16 PNGs under the reference's names, at 16x12 with
    the sample counts cut to 3%, read back."""
    ref_src = (REPO / "tools" / "make_parity_gallery.py").read_text()
    assert set(gallery.NAMES) == set(re.findall(r'"(\d\d_\w+\.png)"', ref_src))
    written = gallery.main(["--out", str(tmp_path), "--width", "16",
                            "--height", "12", "--spp-scale", "0.03",
                            "--device", "cpu"])
    assert [Path(p).name for p in written] == list(gallery.NAMES)
    for p in written:
        img = image_io.read_png(p)
        assert img.shape == (12, 16, 3) and img.dtype == np.uint8
