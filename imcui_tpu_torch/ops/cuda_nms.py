"""Fused NMS + 4×4 cell reduction (kernel ``csrc/nms_cellmax.cu``).

Replaces ``imcui_tpu/ops/pallas_nms.py:nms_cellmax`` and its wrapper
``select_keypoints``. After radius-r NMS with r ≥ 3 the surviving maxima
are at least r+1 ≥ 4 px apart, so a 4×4 cell holds at most one survivor
and the top-k runs on the 16× smaller cell grid. The top-k is exact
(``torch.topk``); the TPU path used ``lax.approx_max_k``, whose recall
this is a superset of.
"""

import ctypes

import torch

from . import _build
from .nms import border_mask, simple_nms

# The radii whose survivors are at least 4 px apart (r + 1 >= 4), so that a
# 4x4 cell holds at most one, up to the largest the kernel takes.
MIN_RADIUS, MAX_RADIUS = 3, 6


def supported(h, w, radius):
    """Whether NMS at ``radius`` on an (H, W) heatmap is K2's function:
    the cell reduction is exact for r >= 3 and the kernel takes H, W
    multiples of 4 and r <= 6. Elsewhere SuperPoint runs the reference's
    per-pixel chain (``simple_nms`` -> ``border_mask`` -> top-k), as the
    JAX package does outside ``pallas_nms.supported``."""
    return MIN_RADIUS <= radius <= MAX_RADIUS and h % 4 == 0 and w % 4 == 0


def _first_max(v, dim):
    """Max over ``dim`` and the first index attaining it."""
    m = v.amax(dim, keepdim=True)
    n = v.shape[dim]
    shape = [1] * v.dim()
    shape[dim] = n
    ar = torch.arange(n, device=v.device).view(shape)
    idx = torch.where(v == m, ar, n).amin(dim)
    return m.squeeze(dim), idx


def nms_cellmax_plain(heat, valid_wh, radius=4, border=4):
    """Plain PyTorch version. heat: (B, H, W) bf16 or float32; valid_wh:
    (B, 2) int (w, h). Returns (cellmax, cellsub), (B, H/4, W/4) float32:
    each cell's NMS'd, masked max and its in-cell position 4·dy + dx,
    where ties go to the first column holding the max, then the first row
    in it, and the position is 0 where the max is 0. Refuses a radius
    below 3, where a cell may hold two survivors and the reduction is
    not the function."""
    b, h, w = heat.shape
    if radius < MIN_RADIUS:
        raise ValueError(f"nms_cellmax keeps one survivor per 4x4 cell, "
                         f"which needs radius >= {MIN_RADIUS}; got {radius}")
    x = heat.float()
    s = simple_nms(x, radius)
    s = torch.where(border_mask(h, w, border, valid_wh, device=x.device), s,
                    torch.zeros_like(s))
    cells = s.reshape(b, h // 4, 4, w // 4, 4)          # b, cy, dy, cx, dx
    vmax, vidx = _first_max(cells, 2)                   # over dy
    cmax, hidx = _first_max(vmax, 3)                    # over dx
    vsel = torch.gather(vidx, 3, hidx[..., None])[..., 0]
    sub = (vsel * 4 + hidx).float()
    return cmax, torch.where(cmax > 0, sub, torch.zeros_like(sub))


def nms_cellmax(heat, valid_wh, radius=4, border=4):
    """Kernel K2 on CUDA tensors; the plain version on CPU tensors.
    heat: (B, H, W) bf16 with H, W multiples of 4; valid_wh: (B, 2) int32."""
    if heat.device.type == "cpu":
        return nms_cellmax_plain(heat, valid_wh, radius, border)
    b, h, w = heat.shape
    if not supported(h, w, radius):
        raise ValueError(f"nms_cellmax takes H, W multiples of 4 and "
                         f"{MIN_RADIUS} <= radius <= {MAX_RADIUS}; got "
                         f"{(h, w)}, radius {radius}")
    _build.require(heat, "heat", torch.bfloat16)
    vwh = valid_wh.to(device=heat.device, dtype=torch.int32).contiguous()
    _build.require(vwh, "valid_wh", torch.int32, (b, 2))
    cmax = torch.empty((b, h // 4, w // 4), dtype=torch.float32,
                       device=heat.device)
    csub = torch.empty_like(cmax)
    code = _build.library().nms_cellmax_f32(
        _build.ptr(heat), _build.ptr(vwh), _build.ptr(cmax), _build.ptr(csub),
        b, h, w, radius, border, _build.stream_of(heat))
    _build.check(code, "nms_cellmax")
    nms_cellmax.launches += 1
    return cmax, csub


nms_cellmax.launches = 0


def nms_plan(b, h, w, radius=4):
    """K2's launch on the current card for a (B, H, W) heatmap: output rows
    and columns a block, region rows it loads (64 + 10r), blocks, blocks
    an SM holds, SMs, rounds (blocks over what the card holds at once,
    rounded up) and shared memory a block in bytes."""
    out = (ctypes.c_int * 8)()
    code = _build.library().nms_cellmax_plan(b, h, w, radius,
                                             ctypes.cast(out, ctypes.c_void_p))
    _build.check(code, "nms_cellmax_plan")
    keys = ("tile_rows", "tile_cols", "region_rows", "blocks",
            "blocks_per_sm", "sms", "rounds", "smem_bytes")
    return dict(zip(keys, out))


def select_keypoints(heat, valid_wh, k, threshold, radius=4, border=4):
    """NMS → border/valid mask → exact top-k in one pass over the heatmap.
    Returns kpts (B, k, 2) xy float32, scores (B, k), mask (B, k)."""
    b, hh, ww = heat.shape
    cmax, csub = nms_cellmax(heat, valid_wh, radius, border)
    wc = ww // 4
    flat = cmax.reshape(b, -1)
    n_cells = flat.shape[1]
    if k > n_cells:
        # fewer cells than slots: take every cell, pad the rest with -inf so
        # the threshold mask below zeroes them
        flat = torch.cat([flat, flat.new_full((b, k - n_cells),
                                              float("-inf"))], 1)
    kscores, idx = torch.topk(flat, k, dim=1)
    idx = idx.clamp_max(n_cells - 1)
    sub = torch.gather(csub.reshape(b, -1), 1, idx)
    ys = (idx // wc).float() * 4.0 + torch.floor(sub / 4.0)
    xs = (idx % wc).float() * 4.0 + torch.remainder(sub, 4.0)
    kpts = torch.stack([xs, ys], -1)
    mask = kscores > threshold
    kscores = torch.where(mask, kscores, torch.zeros_like(kscores))
    kpts = torch.where(mask[..., None], kpts, torch.zeros_like(kpts))
    return kpts, kscores, mask
