"""Two-view relative pose and the pose-error metrics. Counterpart of
``imcui_tpu/ops/pose.py``: fundamental RANSAC (``ops/ransac.py``) →
essential matrix → the four (R, t) candidates → cheirality → angular
errors → AUC. Float32 with TF32 off (``layers.full_fp32``), on the device
of the inputs; the 3 × 3 SVDs, inverses and determinants are
``torch.linalg``'s (LAPACK on the CPU, cuSOLVER on the card).

SVD sign and column conventions differ between libraries: the four
candidates of ``decompose_essential`` are the same set in another order
than the JAX package's, and ``recover_pose`` picks the same (R, t)
wherever the counts have a unique maximum.
"""

import numpy as np
import torch

from .. import resolve_device
from ..models.layers import full_fp32
from .ransac import minimal_size, ransac_from_indices, sample_indices

_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def essential_from_fundamental(F, K0, K1):
    """E = K1ᵀ F K0, projected onto the essential manifold (σ1 = σ2, σ3 =
    0). (..., 3, 3) each."""
    with full_fp32():
        E = K1.transpose(-1, -2) @ F @ K0
        U, S, Vt = torch.linalg.svd(E)
        s = (S[..., 0] + S[..., 1]) / 2.0
        sv = torch.stack([s, s, torch.zeros_like(s)], -1)
        return (U * sv[..., None, :]) @ Vt


def decompose_essential(E):
    """The four candidate (R, t) of E (3, 3): Rs (4, 3, 3), ts (4, 3), in
    the order R1 t, R1 −t, R2 t, R2 −t."""
    with full_fp32():
        U, _, Vt = torch.linalg.svd(E)
        U = U * torch.sign(torch.linalg.det(U))
        Vt = Vt * torch.sign(torch.linalg.det(Vt))
        W = torch.tensor(_W, dtype=E.dtype, device=E.device)
        R1 = U @ W @ Vt
        R2 = U @ W.T @ Vt
        t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _triangulate_depths(R, t, x0, x1):
    """Depths of each ray pair in both cameras by the 2 × 2 least squares
    x1·d1 ≈ R x0·d0 + t. R (..., 3, 3), t (..., 3); x0/x1: (N, 3) unit-plane
    rays. Returns d0, d1 (..., N)."""
    Rx0 = x0 @ R.transpose(-1, -2)
    a = (Rx0 * Rx0).sum(-1)
    b = -(Rx0 * x1).sum(-1)
    c = (x1 * x1).sum(-1)
    rhs0 = -(Rx0 * t[..., None, :]).sum(-1)
    rhs1 = (x1 * t[..., None, :]).sum(-1)
    det = a * c - b * b
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    return (c * rhs0 - b * rhs1) / det, (a * rhs1 - b * rhs0) / det


def recover_pose(E, pts0, pts1, K0, K1, mask=None):
    """The candidate (R, t) with the most points in front of both cameras
    (``cv2.recoverPose``'s rule, the four candidates at once); the first on
    a tie, as ``jnp.argmax``. pts*: (N, 2) pixels. Returns R (3, 3), t (3,)
    and the count."""
    with full_fp32():
        def normalize(p, K):
            ph = torch.cat([p, torch.ones_like(p[:, :1])], -1)
            return ph @ torch.linalg.inv(K).T

        x0, x1 = normalize(pts0, K0), normalize(pts1, K1)
        if mask is None:
            mask = torch.ones(pts0.shape[0], dtype=torch.bool,
                              device=pts0.device)
        Rs, ts = decompose_essential(E)
        d0, d1 = _triangulate_depths(Rs, ts, x0, x1)
        counts = ((d0 > 0) & (d1 > 0) & mask).sum(-1)
        best = torch.argmax(counts)
    return Rs[best], ts[best], counts[best]


def rotation_angle_deg(R_est, R_gt):
    """Geodesic rotation error in degrees."""
    with full_fp32():
        tr = (R_est.transpose(-1, -2) @ R_gt).diagonal(0, -2, -1).sum(-1)
    cos = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def translation_angle_deg(t_est, t_gt):
    """Angle between the translation directions in degrees, the sign
    ambiguity resolved by the smaller of the two."""
    t_est = t_est / torch.linalg.vector_norm(t_est, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
    t_gt = t_gt / torch.linalg.vector_norm(t_gt, dim=-1,
                                           keepdim=True).clamp_min(1e-12)
    cos = (t_est * t_gt).sum(-1).abs().clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def pose_error(R_est, t_est, R_gt, t_gt):
    """max(rotation error, translation error) in degrees, the MegaDepth
    metric."""
    return torch.maximum(rotation_angle_deg(R_est, R_gt),
                         translation_angle_deg(t_est, t_gt))


def pose_auc(errors, thresholds=(5.0, 10.0, 20.0)):
    """Area under the recall curve of the pose errors up to each
    threshold, over the threshold (numpy, on the host). The trapezoid sum
    is written out: ``np.trapz`` is deprecated in NumPy 2."""
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = []
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[max(last - 1, 0)]]])
        e = np.concatenate([errors[:last], [t]])
        area = float(np.sum((e[1:] - e[:-1]) * (r[1:] + r[:-1]) / 2.0))
        aucs.append(area / t)
    return aucs


def estimate_pose_from_indices(idx, pts0, pts1, mask, K0, K1,
                               threshold_px=1.0):
    """``estimate_pose`` on a given hypothesis index set idx (S, 8) of the
    valid correspondences (a test feeds the JAX package's draw)."""
    out = ransac_from_indices(idx[None], pts0[None], pts1[None], mask[None],
                              model="fundamental", threshold=threshold_px)
    out = {k: v[0] for k, v in out.items()}
    E = essential_from_fundamental(out["M"], K0, K1)
    R, t, _ = recover_pose(E, pts0, pts1, K0, K1, mask=out["inliers"])
    return {"R": R, "t": t, **out}


def estimate_pose(pts0, pts1, mask, K0, K1, generator, threshold_px=1.0,
                  num_hypotheses=2048, device="cuda"):
    """Relative pose of one pair from padded correspondences: fundamental
    RANSAC (``num_hypotheses`` drawn from ``generator``, a torch.Generator
    on ``device``) → essential → decomposition → cheirality. pts*: (N, 2)
    pixels, mask (N,), K*: (3, 3). Returns R, t, M (the fundamental
    matrix), inliers, num_inliers and score."""
    dev = resolve_device(device)
    pts0, pts1, K0, K1 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                          for a in (pts0, pts1, K0, K1))
    mask = torch.as_tensor(mask, device=dev).bool()
    idx = sample_indices(mask[None], num_hypotheses,
                         minimal_size("fundamental"), generator)[0]
    return estimate_pose_from_indices(idx, pts0, pts1, mask, K0, K1,
                                      threshold_px)
