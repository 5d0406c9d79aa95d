"""Texture bank: padded image atlas + procedural checker (twin of
raytracer_project_tpu/models/textures.py, builder subset).

The fused pool samples inside its kernels (ops/fused_step.py); the
chunked integrator calls `sample` and `sample_bump_deltas` here, the
unfused pool `sample_soa` and `sample_bump_deltas`. The module
also holds the packed table and its host-side builder. Semantics follow
texture.hpp:50-78 and :118-126 (nearest-neighbour, u wraps, v clamps,
failed loads are cyan, the checker takes the parity of floored cells).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.tree import to_device

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


def _texel_ij(bank: TextureBank, tid, u, v):
    """Nearest texel (i, j) of (u, v) in texture tid: u wraps, v clamps."""
    w = bank.size[tid, 0]
    h = bank.size[tid, 1]
    uu = u - torch.floor(u)
    i = torch.minimum(torch.clamp((uu * w).to(torch.int64), min=0),
                      torch.clamp(w - 1, min=0))
    j = torch.minimum(torch.clamp((v * h).to(torch.int64), min=0),
                      torch.clamp(h - 1, min=0))
    return i, j


def sample(bank: TextureBank, tex_id, u, v, p, default):
    """Texture colors f32[N, 3] (texture.hpp:50-78, :118-126): tex_id
    i32[N], u, v f32[N], p f32[N, 3]; `default` [N, 3] where tex_id < 0
    (the material's solid albedo)."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    kind = bank.kind[tid]
    i, j = _texel_ij(bank, tid, u, v)
    image_color = bank.data[tid, j, i]
    cells = torch.floor(bank.checker_inv_scale[tid][:, None] * p)
    cells = cells.to(torch.int64)
    is_even = cells.sum(-1) % 2 == 0
    checker = torch.where(is_even[:, None], bank.checker_even[tid],
                          bank.checker_odd[tid])
    color = torch.where((kind == KIND_IMAGE)[:, None], image_color, checker)
    cyan = torch.tensor(_CYAN, dtype=color.dtype, device=color.device)
    color = torch.where((kind == KIND_MISSING)[:, None], cyan, color)
    return torch.where((tex_id < 0)[:, None], default, color)


def sample_soa(bank: TextureBank, tex_id, u, v, p, default):
    """SoA twin of `sample` (reference sample_soa, textures.py:107): p and
    default are (x, y, z) tuples of f32[N]; returns an (r, g, b) tuple."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    kind = bank.kind[tid]
    i, j = _texel_ij(bank, tid, u, v)
    image = bank.data[tid, j, i]
    inv_scale = bank.checker_inv_scale[tid]
    cells = sum(torch.floor(inv_scale * c).to(torch.int64) for c in p)
    is_even = cells % 2 == 0
    even, odd = bank.checker_even[tid], bank.checker_odd[tid]
    out = []
    for c in range(3):
        col = torch.where(kind == KIND_IMAGE, image[:, c],
                          torch.where(is_even, even[:, c], odd[:, c]))
        col = torch.where(kind == KIND_MISSING, _CYAN[c], col)
        out.append(torch.where(tex_id < 0, default[c], col))
    return tuple(out)


def sample_bump_deltas(bank: TextureBank, tex_id, u, v, delta: float):
    """Finite-difference bump taps (h(u+delta, v) - h(u, v), h(u, v+delta)
    - h(u, v)) of channel 0 from one texel load (material.hpp:40-48): the
    difference is 0 when the offset tap stays in the texel, else the
    precomputed neighbour delta. Returns (f_u, f_v) f32[N]; 0 where
    tex_id < 0."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    i, j = _texel_ij(bank, tid, u, v)
    g = bank.grad[tid, j, i]
    i2, _ = _texel_ij(bank, tid, u + delta, v)
    _, j2 = _texel_ij(bank, tid, u, v + delta)
    has = tex_id >= 0
    return (torch.where((i2 != i) & has, g[:, 0], 0.0),
            torch.where((j2 != j) & has, g[:, 1], 0.0))


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
