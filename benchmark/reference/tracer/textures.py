"""Frozen copy of raytracer_project_tpu_torch/models/textures.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from .tree import to_device


KIND_IMAGE = 0


KIND_CHECKER = 1


KIND_MISSING = 2  # failed load -> cyan sentinel


class TextureBank(NamedTuple):
    """All scene textures packed into one padded atlas.

      data              f32[K, AH, AW, 3] image texels (linear RGB)
      grad              f32[K, AH, AW, 2] channel-0 neighbour deltas
                        (u wraps, v clamps) for the one-tap bump shader
      size              i32[K, 2]         actual (width, height)
      kind              i32[K]            KIND_* tag
      checker_inv_scale f32[K]
      checker_even      f32[K, 3]
      checker_odd       f32[K, 3]
    """

    data: torch.Tensor
    grad: torch.Tensor
    size: torch.Tensor
    kind: torch.Tensor
    checker_inv_scale: torch.Tensor
    checker_even: torch.Tensor
    checker_odd: torch.Tensor

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def to(self, device):
        return to_device(self, device)


_CYAN = (0.0, 1.0, 1.0)


class TextureBankBuilder:
    """Host-side accumulation of textures; `pack()` pads into the atlas."""

    def __init__(self):
        self._images: list[np.ndarray | None] = []
        self._kinds: list[int] = []
        self._checker: list[tuple[float, tuple, tuple]] = []

    def _push(self, kind, image=None, checker=(1.0, (0, 0, 0), (0, 0, 0))) -> int:
        tid = len(self._kinds)
        self._kinds.append(kind)
        self._images.append(image)
        self._checker.append(checker)
        return tid

    def add_image(self, pixels: np.ndarray) -> int:
        """pixels: float [H, W, 3] linear RGB, row 0 = top."""
        arr = np.asarray(pixels, np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"expected [H,W,3] image, got {arr.shape}")
        return self._push(KIND_IMAGE, image=arr)

    def add_checker(self, scale: float, even, odd) -> int:
        return self._push(KIND_CHECKER,
                          checker=(1.0 / scale, tuple(even), tuple(odd)))

    def add_missing(self) -> int:
        """Failed-load sentinel slot -> cyan (texture.hpp:52-54)."""
        return self._push(KIND_MISSING)

    def pack(self) -> TextureBank:
        """numpy-backed bank; SceneBuilder.build converts it to tensors."""
        kinds = self._kinds or [KIND_MISSING]
        images = self._images or [None]
        checker = self._checker or [(1.0, (0, 0, 0), (0, 0, 0))]

        ah = max([1] + [im.shape[0] for im in images if im is not None])
        aw = max([1] + [im.shape[1] for im in images if im is not None])
        k = len(kinds)
        data = np.zeros((k, ah, aw, 3), np.float32)
        grad = np.zeros((k, ah, aw, 2), np.float32)
        size = np.ones((k, 2), np.int32)
        for t, im in enumerate(images):
            if im is not None:
                h, w = im.shape[:2]
                data[t, :h, :w] = im
                size[t] = (w, h)
                hh = im[:, :, 0]
                grad[t, :h, :w, 0] = np.roll(hh, -1, axis=1) - hh  # u wraps
                grad[t, :h - 1, :w, 1] = hh[1:] - hh[:-1]          # v clamps
        return TextureBank(
            data=data,
            grad=grad,
            size=size,
            kind=np.asarray(kinds, np.int32),
            checker_inv_scale=np.asarray([c[0] for c in checker], np.float32),
            checker_even=np.asarray([c[1] for c in checker], np.float32),
            checker_odd=np.asarray([c[2] for c in checker], np.float32),
        )

