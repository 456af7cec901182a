"""Sampling a dense map at real-valued points. Counterpart of
``imcui_tpu/ops/sampling.py``: ``grid_sample`` in its three modes, zeros
padding (a tap outside the map contributes 0), and ``xfeat_grid``, the
grid normalisation of XFeat's ``InterpolateSparse2d``.

- ``"bilinear"`` (RoMa, XFeat's reliability map) and ``"bicubic"``
  (XFeat's descriptors: the cubic kernel with A = -0.75, each of the 16
  taps weighted on its own and dropped outside the map) are what
  ``torch.nn.functional.grid_sample`` computes with ``padding_mode=
  "zeros"``, which the JAX function restates, so it does the work here.
- ``"nearest"`` is restated as the JAX function has it, the tap at
  floor(x + 0.5): ``F.grid_sample`` rounds half to even, which differs at
  exact half-pixel positions.
"""

import torch
import torch.nn.functional as F


def _unnormalize(g, size, align_corners):
    """Grid coordinate in [-1, 1] → input pixel coordinate (torch rules)."""
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def grid_sample(fmap, grid, mode="bilinear", align_corners=False):
    """Sample ``fmap`` (C, H, W) at ``grid`` (..., 2) of (gx, gy) in
    [-1, 1]; returns (C, ...). A bfloat16 map sampled at float32
    coordinates gives float32, as bf16 values times f32 weights do in the
    JAX function."""
    if mode not in ("bilinear", "bicubic", "nearest"):
        raise ValueError(f"unknown mode {mode}")
    dtype = torch.promote_types(fmap.dtype, grid.dtype)
    c, h, w = fmap.shape
    lead = grid.shape[:-1]
    fmap, grid = fmap.to(dtype), grid.to(dtype)
    if mode == "nearest":
        x0 = torch.floor(_unnormalize(grid[..., 0], w, align_corners) + 0.5)
        y0 = torch.floor(_unnormalize(grid[..., 1], h, align_corners) + 0.5)
        x0, y0 = x0.long().reshape(-1), y0.long().reshape(-1)
        inb = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
        q = y0.clamp(0, h - 1) * w + x0.clamp(0, w - 1)
        val = fmap.reshape(c, h * w)[:, q]
        return torch.where(inb, val, 0.0).reshape(c, *lead)
    out = F.grid_sample(fmap[None], grid.reshape(1, -1, 1, 2), mode=mode,
                        padding_mode="zeros", align_corners=align_corners)
    return out.reshape(c, *lead)


def xfeat_grid(kpts, h, w):
    """XFeat's InterpolateSparse2d grid: pixel coordinates normalised by
    (W - 1, H - 1), the align_corners=True convention, which XFeat then
    samples with align_corners=False. kpts: (..., 2) xy in full-resolution
    pixels."""
    return 2.0 * kpts / kpts.new_tensor([w - 1, h - 1]) - 1.0
