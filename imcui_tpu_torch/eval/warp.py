"""Synthetic-homography accuracy evaluation, offline. Counterpart of
``imcui_tpu/eval/warp.py``: an image is warped by known homographies
(rotations, scales, a perspective tilt around the centre) and
``ImageMatchingAPI`` is scored end to end on each pair by

- **match recall**: the share of matches whose transfer error
  |H·x0 − x1| is under a pixel threshold;
- **homography error**: the mean displacement of the four image corners
  under the RANSAC estimate against the true H.

OpenCV's two calls are restated. ``make_homographies`` builds
``cv2.getRotationMatrix2D``'s matrix. ``warp_image`` is
``cv2.warpPerspective(INTER_LINEAR, BORDER_CONSTANT 0)``: every output
pixel samples the input at H⁻¹·x by bilinear taps with zeros outside
(``ops/sampling.grid_sample`` on the device). OpenCV quantises the source
position to 1/32 px and its uint8 weights to 15 bits; here both are
float32, and a uint8 result is rounded once, so a pixel can differ from
OpenCV's by a grey level or two where the image changes fast.
"""

import numpy as np
import torch

from .. import resolve_device
from ..models.layers import full_fp32
from ..ops.sampling import grid_sample


def rotation_matrix_2d(center, angle_deg, scale):
    """``cv2.getRotationMatrix2D``: the 2 × 3 rotation by ``angle_deg``
    (counter-clockwise on screen) and scaling by ``scale`` about
    ``center`` = (x, y): α = s·cos θ, β = s·sin θ,
    [[α, β, (1 − α)·cx − β·cy], [−β, α, β·cx + (1 − α)·cy]]."""
    cx, cy = center
    theta = np.deg2rad(angle_deg)
    a, b = scale * np.cos(theta), scale * np.sin(theta)
    return np.array([[a, b, (1 - a) * cx - b * cy],
                     [-b, a, b * cx + (1 - a) * cy]], np.float64)


def make_homographies(w, h, angles=(10.0, -15.0), scales=(0.85, 1.15),
                      perspective=0.0005):
    """A small battery of invertible warps around the image centre."""
    hs = []
    for a in angles:
        hs.append(np.vstack([rotation_matrix_2d((w / 2, h / 2), a, 1.0),
                             [0, 0, 1]]))
    for s in scales:
        hs.append(np.vstack([rotation_matrix_2d((w / 2, h / 2), 0.0, s),
                             [0, 0, 1]]))
    hp = np.eye(3)
    hp[2, 0] = perspective
    hs.append(hp)
    return hs


def warp_image(image, H, device="cuda"):
    """``image`` (H, W) or (H, W, C) warped by H onto a canvas of its own
    size, bilinear with zeros outside; the input's dtype (uint8 rounded to
    the nearest level)."""
    dev = resolve_device(device)
    image = np.asarray(image)
    h, w = image.shape[:2]
    src = torch.as_tensor(image.astype(np.float32), device=dev)
    src = src.reshape(h, w, -1).permute(2, 0, 1)
    with full_fp32():
        hinv = torch.as_tensor(np.linalg.inv(np.asarray(H, np.float64)),
                               dtype=torch.float64, device=dev)
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float64, device=dev),
            torch.arange(w, dtype=torch.float64, device=dev), indexing="ij")
        q = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ hinv.T
        z = q[..., 2:]
        ok = z.abs() > 1e-12
        xy = torch.where(ok, q[..., :2] / torch.where(ok, z, 1.0), -2.0)
        # pixel centres → [-1, 1] with align_corners=True
        grid = xy / xy.new_tensor([max(w - 1, 1), max(h - 1, 1)]) * 2 - 1
        out = grid_sample(src, grid.float(), align_corners=True)
    out = out.permute(1, 2, 0).reshape(image.shape).cpu().numpy()
    if image.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


def transfer_error(kpts0, kpts1, H):
    """|H·x0 − x1| per match, in pixels."""
    x = np.concatenate([kpts0, np.ones((len(kpts0), 1))], 1) @ H.T
    x = x[:, :2] / np.maximum(np.abs(x[:, 2:]), 1e-12) * np.sign(x[:, 2:])
    return np.linalg.norm(x - kpts1, axis=1)


def corner_error(H_est, H_true, w, h):
    """Mean displacement of the four image corners under est vs truth."""
    corners = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]],
                       np.float64)

    def apply(H):
        x = corners @ np.asarray(H, np.float64).T
        return x[:, :2] / x[:, 2:]

    return float(np.linalg.norm(apply(H_est) - apply(H_true), axis=1)
                 .mean())


def evaluate_warp(api, image, homographies=None, px_thresh=3.0,
                  device="cuda"):
    """Run ``api`` over (image, warp(image)) pairs, the warps made on
    ``device``. Returns per-warp dicts with n_matches / recall /
    h_corner_err and an aggregate of medians. ``image``: (H, W, 3) uint8
    or float RGB."""
    h, w = image.shape[:2]
    if homographies is None:
        homographies = make_homographies(w, h)
    results = []
    for H in homographies:
        warped = warp_image(image, H, device=device)
        pred = api(image, warped)
        k0 = np.asarray(pred["mmkeypoints0_orig"], np.float64)
        k1 = np.asarray(pred["mmkeypoints1_orig"], np.float64)
        entry = {"n_matches": int(len(k0)), "recall": 0.0,
                 "h_corner_err": float("inf")}
        if len(k0) >= 4:
            err = transfer_error(k0, k1, H)
            entry["recall"] = float((err < px_thresh).mean())
            H_est = pred.get("geom_info", {}).get("Homography")
            if H_est is not None:
                entry["h_corner_err"] = corner_error(H_est, H, w, h)
        results.append(entry)
    agg = {
        "median_recall": float(np.median([r["recall"] for r in results])),
        "median_matches": float(np.median(
            [r["n_matches"] for r in results])),
        "median_h_corner_err": float(np.median(
            [r["h_corner_err"] for r in results])),
    }
    return results, agg
