"""Sampling a dense map at real-valued points. Counterpart of
``imcui_tpu/ops/sampling.py``'s ``grid_sample`` for the mode RoMa uses:
bilinear taps, ``align_corners=False``, zeros padding (a tap outside the
map contributes 0). The bicubic and nearest modes and ``xfeat_grid`` come
with their first user.

``torch.nn.functional.grid_sample`` has exactly these semantics (the JAX
function restates it), so it does the work here.
"""

import torch
import torch.nn.functional as F


def grid_sample(fmap, grid, mode="bilinear", align_corners=False):
    """Sample ``fmap`` (C, H, W) at ``grid`` (..., 2) of (gx, gy) in
    [-1, 1]; returns (C, ...). A bfloat16 map sampled at float32
    coordinates gives float32, as bf16 values times f32 weights do in the
    JAX function."""
    if mode != "bilinear":
        raise NotImplementedError(
            f"grid_sample mode {mode!r} is not ported yet (bilinear is)")
    dtype = torch.promote_types(fmap.dtype, grid.dtype)
    lead = grid.shape[:-1]
    out = F.grid_sample(
        fmap.to(dtype)[None], grid.to(dtype).reshape(1, -1, 1, 2),
        mode="bilinear", padding_mode="zeros", align_corners=align_corners)
    return out.reshape(fmap.shape[0], *lead)
