"""Calibrated synthetic-pose pairs for offline relative-pose evaluation.
Counterpart of ``imcui_tpu/eval/synthpose.py``; the scene sampler, the
per-plane homographies, the renderer and the analytic correspondences are
its numpy code, so one ``np.random.default_rng`` gives the same arrays.

Each photo is carved into vertical strips, strip i on its own 3-D plane
nᵢᵀX = dᵢ; all strips move under one rigid (R, t), so the scene is
piecewise planar and (with two planes or more) determines F uniquely.
View 1 is rendered by exact per-plane inverse-homography lookup with
z-buffering, Hᵢ = K1 (R − t nᵢᵀ / dᵢ) K0⁻¹ (Hartley & Zisserman §13.2).

``generate_pairs`` is restated without OpenCV: images are read by
``utils/image.read_image`` (PNG, JPEG and binary PGM/PPM; any other
format raises and names itself), resized by ``utils/image.resize_linear``
(``cv2.INTER_LINEAR``'s weights, rounded to uint8 once; OpenCV's
fixed-point weights can round a pixel to the next grey level) and
written by ``utils/png.encode_png``. OpenCV reads and writes BGR, this
package RGB; no operation mixes the channels, so the files hold the same
pixels.
"""

import json
import pathlib

import numpy as np

from ..utils.image import read_image, resize_linear
from ..utils.png import encode_png

def _rotation(axis, angle_rad):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle_rad) * K
            + (1 - np.cos(angle_rad)) * (K @ K))


def sample_scene(rng, w, h, n_planes=3, max_rot_deg=12.0,
                 max_trans_frac=0.25, max_tilt_deg=12.0):
    """Random calibrated scene: K, rigid (R, t), and per-strip planes.

    Returns dict with K (3,3), R (3,3), t (3,), planes = list of
    (n (3,), d float) and x_edges — strip boundaries in view-0 pixels.
    Depth scale is anchored at 1.0 (t is in those units; only its
    direction is scored by pose_error, as in the real eval)."""
    f = 1.2 * max(w, h)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])

    angle = np.deg2rad(rng.uniform(3.0, max_rot_deg))
    axis = rng.normal(size=3)
    R = _rotation(axis, angle)
    # translation: sideways-biased (MegaDepth-style baselines), scaled
    # to scene depth 1.0
    t = rng.normal(size=3) * np.array([1.0, 0.6, 0.4])
    t = t / np.linalg.norm(t) * rng.uniform(0.08, max_trans_frac)

    planes = []
    for _ in range(n_planes):
        tilt = np.deg2rad(rng.uniform(0.0, max_tilt_deg))
        taxis = rng.normal(size=2)
        taxis = taxis / np.linalg.norm(taxis)
        n = _rotation([taxis[0], taxis[1], 0.0], tilt) @ np.array(
            [0.0, 0.0, 1.0])
        d = rng.uniform(0.75, 1.35)  # plane offset: n·X = d
        planes.append((n, d))
    x_edges = np.linspace(0, w, n_planes + 1)
    return {"K": K, "R": R, "t": t, "planes": planes, "x_edges": x_edges}


def _plane_homographies(scene):
    K, R, t = scene["K"], scene["R"], scene["t"]
    Hs = []
    for n, d in scene["planes"]:
        Hs.append(K @ (R - np.outer(t, n) / d) @ np.linalg.inv(K))
    return Hs


def render_view1(img, scene):
    """Render view 1 of the piecewise-planar scene (z-buffered exact
    per-plane inverse warp). img: (H, W) or (H, W, 3) uint8/float.
    Returns (img1 same dtype, valid (H, W) bool)."""
    h, w = img.shape[:2]
    Hs = _plane_homographies(scene)
    Kinv = np.linalg.inv(scene["K"])
    R, t = scene["R"], scene["t"]
    x_edges = scene["x_edges"]

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ones = np.ones_like(xs)
    u1 = np.stack([xs, ys, ones], -1).reshape(-1, 3)  # view-1 pixels

    best_z = np.full(u1.shape[0], np.inf)
    best_u0 = np.zeros((u1.shape[0], 2))
    hit = np.zeros(u1.shape[0], bool)
    for i, (Hmat, (n, d)) in enumerate(zip(Hs, scene["planes"])):
        u0 = u1 @ np.linalg.inv(Hmat).T
        u0 = u0[:, :2] / u0[:, 2:3]
        in_strip = ((u0[:, 0] >= x_edges[i]) & (u0[:, 0] < x_edges[i + 1])
                    & (u0[:, 0] >= 0) & (u0[:, 0] <= w - 1)
                    & (u0[:, 1] >= 0) & (u0[:, 1] <= h - 1))
        # depth of the 3-D point in camera-1 frame (z-buffer key)
        ray = np.concatenate([u0, np.ones((len(u0), 1))], 1) @ Kinv.T
        denom = ray @ n
        depth0 = np.where(np.abs(denom) > 1e-9, d / denom, np.inf)
        X0 = ray * depth0[:, None]
        z1 = X0 @ R[2] + t[2]
        ok = in_strip & (depth0 > 0) & (z1 > 0) & (z1 < best_z)
        best_z = np.where(ok, z1, best_z)
        best_u0 = np.where(ok[:, None], u0, best_u0)
        hit |= ok

    # bilinear sample from view 0
    x0 = np.clip(best_u0[:, 0], 0, w - 1)
    y0 = np.clip(best_u0[:, 1], 0, h - 1)
    xi, yi = np.floor(x0).astype(int), np.floor(y0).astype(int)
    xi1, yi1 = np.minimum(xi + 1, w - 1), np.minimum(yi + 1, h - 1)
    fx, fy = x0 - xi, y0 - yi
    imgf = img.astype(np.float64)
    if imgf.ndim == 2:
        imgf = imgf[..., None]
    smp = ((imgf[yi, xi] * (1 - fx)[:, None] + imgf[yi, xi1] * fx[:, None])
           * (1 - fy)[:, None]
           + (imgf[yi1, xi] * (1 - fx)[:, None]
              + imgf[yi1, xi1] * fx[:, None]) * fy[:, None])
    smp = np.where(hit[:, None], smp, 0.0).reshape(h, w, -1)
    if img.ndim == 2:
        smp = smp[..., 0]
    return smp.astype(img.dtype), hit.reshape(h, w)


def gt_correspondences(scene, w, h, rng, n=512):
    """Analytic GT matches (u0, u1) for harness self-tests: sample
    view-0 pixels, push through the owning strip's homography, keep the
    ones that land in view 1 un-occluded (front-most plane)."""
    Hs = _plane_homographies(scene)
    x_edges = scene["x_edges"]
    u0 = np.stack([rng.uniform(0, w - 1, n * 4),
                   rng.uniform(0, h - 1, n * 4),
                   np.ones(n * 4)], -1)
    strip = np.clip(np.searchsorted(x_edges, u0[:, 0], side="right") - 1,
                    0, len(Hs) - 1)
    u1 = np.stack([u0[i] @ Hs[s].T for i, s in enumerate(strip)])
    u1 = u1[:, :2] / u1[:, 2:3]
    inb = ((u1[:, 0] >= 0) & (u1[:, 0] <= w - 1)
           & (u1[:, 1] >= 0) & (u1[:, 1] <= h - 1))
    return u0[inb][:n, :2], u1[inb][:n]


def _load_view0(path, size):
    """The photo as (H, W, 3) uint8 RGB, resized to ``size`` = (h, w) as
    ``cv2.resize(INTER_LINEAR)`` on uint8 does, up to its rounding."""
    img = read_image(path)
    if size is not None and img.shape[:2] != tuple(size):
        img = resize_linear(img, (size[1], size[0]))
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img


def generate_pairs(corpus_paths, out_dir, n_pose_per_image=3,
                   n_planes=3, size=None, seed=0):
    """Materialise synthetic-pose pairs: renders PNGs under ``out_dir``
    and writes ``pairs.json`` in eval/megadepth's pair-list schema
    (img0/img1 paths, K0/K1, R, t). Returns the pair list."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pairs = []
    for pi, path in enumerate(corpus_paths):
        img = _load_view0(path, size)
        h, w = img.shape[:2]
        p0 = out_dir / f"scene{pi:03d}_view0.png"
        p0.write_bytes(encode_png(img))
        for vi in range(n_pose_per_image):
            scene = sample_scene(rng, w, h, n_planes=n_planes)
            img1, valid = render_view1(img, scene)
            if valid.mean() < 0.4:  # too little overlap to be a fair pair
                continue
            p1 = out_dir / f"scene{pi:03d}_view{vi + 1}.png"
            p1.write_bytes(encode_png(img1))
            pairs.append({
                "img0": str(p0), "img1": str(p1),
                "K0": scene["K"].tolist(), "K1": scene["K"].tolist(),
                "R": scene["R"].tolist(), "t": scene["t"].tolist(),
            })
    with open(out_dir / "pairs.json", "w") as f:
        json.dump(pairs, f)
    return pairs
