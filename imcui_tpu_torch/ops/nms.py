"""Keypoint detection ops: window NMS, border masking, fixed-k selection,
sub-pixel refinement, descriptor sampling (SuperPoint's on its 1/8 grid,
``sample_bilinear`` on a full-resolution map for ALIKE and ALIKED).
Counterpart of ``imcui_tpu/ops/nms.py``, but for its cell-max route of
``select_topk_keypoints`` (``_select_topk_cellmax``), which no ported
caller takes: bf16 SuperPoint selects through ``ops/cuda_nms.py``.

Shapes stay fixed: ``k`` keypoint slots and a validity mask instead of a
dynamic keypoint count.
"""

import torch
import torch.nn.functional as F


def max_pool_2d(x, radius):
    """Max over a (2r+1)² window, stride 1, −inf padding at the edges
    (``lax.reduce_window`` SAME). x: (..., H, W)."""
    shape = x.shape
    x4 = x.reshape(-1, 1, *shape[-2:])
    out = F.max_pool2d(x4, 2 * radius + 1, stride=1, padding=radius)
    return out.reshape(shape)


def simple_nms(scores, radius, iterations=2):
    """SuperPoint's iterative NMS: keep a score where it equals its window
    max; two suppression rounds recover maxima beside suppressed ones.
    scores: (..., H, W) → same shape, zeros where suppressed."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_2d(scores, radius)
    for _ in range(iterations):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def border_mask(h, w, border, valid_wh=None, device="cpu"):
    """(B, H, W) bool mask (or (H, W) without ``valid_wh``): False within
    ``border`` px of the edge and beyond the valid (w, h) region of a
    padded canvas. valid_wh: (B, 2) int."""
    ys = torch.arange(h, device=device).view(h, 1)
    xs = torch.arange(w, device=device).view(1, w)
    if valid_wh is None:
        return (ys >= border) & (xs >= border) & (ys < h - border) \
            & (xs < w - border)
    vw = valid_wh[:, 0].view(-1, 1, 1)
    vh = valid_wh[:, 1].view(-1, 1, 1)
    return ((ys >= border) & (xs >= border) & (ys < vh - border)
            & (xs < vw - border))


def select_topk_keypoints(scores, k, threshold=0.0):
    """Exact fixed-k keypoint selection from NMS'd, border-masked score
    maps. scores: (B, H, W). Returns kpts (B, k, 2) float32 xy, kscores
    (B, k) (0 where invalid) and mask (B, k) = kscores > threshold."""
    b, h, w = scores.shape
    kscores, idx = torch.topk(scores.reshape(b, -1), k, dim=1)
    ys = (idx // w).float()
    xs = (idx % w).float()
    kpts = torch.stack([xs, ys], -1)
    mask = kscores > threshold
    kscores = torch.where(mask, kscores, torch.zeros_like(kscores))
    kpts = torch.where(mask[..., None], kpts, torch.zeros_like(kpts))
    return kpts, kscores, mask


def soft_argmax_refinement(kpts, scores, radius=2):
    """Sub-pixel refinement: soft-argmax over a (2r+1)² patch of
    ``scores`` around each keypoint, patch indices clamped to the map.
    kpts: (B, k, 2) xy; scores: (B, H, W) → (B, k, 2)."""
    b, h, w = scores.shape
    d = torch.arange(-radius, radius + 1, device=scores.device)
    dy, dx = d.view(1, 1, -1, 1), d.view(1, 1, 1, -1)
    ix = (kpts[..., 0].to(torch.int64)[..., None, None] + dx).clamp(0, w - 1)
    iy = (kpts[..., 1].to(torch.int64)[..., None, None] + dy).clamp(0, h - 1)
    win = 2 * radius + 1
    patches = torch.gather(scores.reshape(b, -1), 1,
                           (iy * w + ix).reshape(b, -1))
    patches = patches.reshape(b, -1, win, win)
    weights = patches / patches.sum((-1, -2), keepdim=True).clamp_min(1e-8)
    off_x = (weights * dx).sum((-1, -2))
    off_y = (weights * dy).sum((-1, -2))
    return kpts + torch.stack([off_x, off_y], -1)


def sample_descriptors(kpts, desc_map, s=8):
    """Bilinear descriptor sampling at keypoints (torch ``grid_sample``
    with ``align_corners=True`` and SuperPoint's coordinate mapping), then
    L2 normalisation. kpts: (B, k, 2) xy pixels; desc_map: (B, C, Hc, Wc)
    → (B, C, k)."""
    b, c, hc, wc = desc_map.shape
    kp = kpts - s / 2 + 0.5
    kp = kp / kp.new_tensor([wc * s - s / 2 - 0.5, hc * s - s / 2 - 0.5])
    kp = kp * 2 - 1
    gx = (kp[..., 0] + 1.0) * 0.5 * (wc - 1)
    gy = (kp[..., 1] + 1.0) * 0.5 * (hc - 1)
    x0 = torch.floor(gx).long().clamp(0, wc - 1)
    y0 = torch.floor(gy).long().clamp(0, hc - 1)
    x1 = (x0 + 1).clamp(0, wc - 1)
    y1 = (y0 + 1).clamp(0, hc - 1)
    wx = (gx - x0).clamp(0.0, 1.0)[:, None]
    wy = (gy - y0).clamp(0.0, 1.0)[:, None]
    flat = desc_map.reshape(b, c, hc * wc)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * wc + xx)[:, None].expand(-1, c, -1))

    desc = (at(y0, x0) * ((1 - wx) * (1 - wy))
            + at(y0, x1) * (wx * (1 - wy))
            + at(y1, x0) * ((1 - wx) * wy)
            + at(y1, x1) * (wx * wy))
    norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    return desc / norm.clamp_min(1e-8)


def sample_bilinear(fmap, kpts):
    """Bilinear interpolation of a full-resolution map at pixel
    coordinates: torch ``grid_sample(..., align_corners=True)`` with
    ALIKE's normalisation ``kpts / [w - 1, h - 1] * 2 - 1``, which maps a
    pixel coordinate back to itself. Coordinates are clamped to the map.
    fmap: (B, C, H, W); kpts: (B, k, 2) xy pixels → (B, C, k), not
    normalised."""
    b, c, h, w = fmap.shape
    gx = kpts[..., 0].clamp(0.0, w - 1.0)
    gy = kpts[..., 1].clamp(0.0, h - 1.0)
    x0 = torch.floor(gx).long().clamp(0, w - 1)
    y0 = torch.floor(gy).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = fmap.reshape(b, c, h * w)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * w + xx)[:, None].expand(-1, c, -1))

    return (at(y0, x0) * (1 - wx) * (1 - wy)
            + at(y0, x1) * wx * (1 - wy)
            + at(y1, x0) * (1 - wx) * wy
            + at(y1, x1) * wx * wy)


def depth_to_space(x, block):
    """(B, C·b², H, W) → (B, C, H·b, W·b); channel ``c·b² + i·b + j`` lands
    at offset (i, j) of its cell, which is torch's pixel shuffle."""
    return F.pixel_shuffle(x, block)
