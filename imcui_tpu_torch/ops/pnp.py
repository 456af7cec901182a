"""Absolute pose (PnP) by RANSAC. Counterpart of ``imcui_tpu/ops/pnp.py``:
6-point DLT hypotheses for every draw at once, reprojection scoring as one
(S, N) matrix with the MAGSAC-style truncated quality, two rounds of
weighted DLT on the inliers, then a Procrustes projection of the winner
onto SO(3) with its scale and sign fixed by cheirality.

As in ``ops/ransac.py`` the draw (``sample_pnp_indices``, Gumbel top-6
over the valid correspondences) is kept apart from the core
(``ransac_pnp_from_indices``), so a test can feed the JAX package's index
set. Float32 with TF32 off, on the inputs' device.
"""

import torch

from .. import resolve_device
from ..models.layers import full_fp32
from .ransac import sample_indices, solve_nullvec_fix_last

MIN_PNP_POINTS = 6


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _dlt_rows(x2d, X3d):
    """DLT rows of P = [R|t] (row-major p, 12 entries) for each point:
    (..., m, 2), (..., m, 3) → the u rows and the v rows, (..., m, 12)
    each."""
    X = _hom(X3d)
    zeros = torch.zeros_like(X)
    rows_u = torch.cat([X, zeros, -x2d[..., 0:1] * X], -1)
    rows_v = torch.cat([zeros, X, -x2d[..., 1:2] * X], -1)
    return rows_u, rows_v


def _dlt_camera_matrices(x2d, X3d):
    """Batched DLT for P from K-normalised points. x2d: (S, m, 2), X3d:
    (S, m, 3) → P (S, 3, 4) up to scale, not orthogonalised."""
    rows_u, rows_v = _dlt_rows(x2d, X3d)
    p = solve_nullvec_fix_last(torch.cat([rows_u, rows_v], -2))
    return p.reshape(-1, 3, 4)


def _weighted_dlt_rows(x2d, X3d, sw):
    """Weighted DLT rows over all points. x2d (N, 2), X3d (N, 3), sw (N,)
    square-root weights → (2N, 12)."""
    rows_u, rows_v = _dlt_rows(x2d, X3d)
    return torch.cat([rows_u * sw[:, None], rows_v * sw[:, None]], 0)


def _orthogonalize(P, x2d, X3d):
    """The left 3 × 3 of P (3, 4) projected onto SO(3) (Procrustes), the
    scale taken as the mean singular value and the sign flipped when most
    points lie behind the camera. Returns R (3, 3), t (3,)."""
    U, S, Vt = torch.linalg.svd(P[:, :3])
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det])
    R = U @ torch.diag(d) @ Vt
    t = P[:, 3] / S.mean().clamp_min(1e-12)
    depths = X3d @ R[2] + t[2]
    flip = (depths < 0).sum() > (depths.shape[0] // 2)
    return torch.where(flip, -R, R), torch.where(flip, -t, t)


def _reprojection_errors(P, x2d, X3d):
    """Squared reprojection error on the normalised plane, infinite for
    points behind the camera. P (S, 3, 4), x2d (N, 2), X3d (N, 3) → (S,
    N)."""
    proj = torch.einsum("sij,nj->sni", P, _hom(X3d))
    z = proj[..., 2:]
    uv = proj[..., :2] / torch.where(z.abs() < 1e-9,
                                     torch.full_like(z, 1e-9), z)
    err = ((uv - x2d[None]) ** 2).sum(-1)
    return torch.where(z[..., 0] <= 0, torch.full_like(err, float("inf")),
                       err)


def sample_pnp_indices(mask, num_hypotheses, generator):
    """(S, 6) minimal sets drawn without replacement from the valid
    correspondences (Gumbel top-k), mask (N,)."""
    return sample_indices(mask[None], num_hypotheses, MIN_PNP_POINTS,
                          generator)[0]


def ransac_pnp_from_indices(idx, points2D, points3D, mask, K,
                            threshold_px=12.0, lo_iters=2):
    """The PnP RANSAC core on a given index set idx (S, 6). points2D (N,
    2) pixels, points3D (N, 3), mask (N,) validity, K (3, 3). Returns R, t
    (world → camera), inliers, num_inliers and success."""
    with full_fp32():
        xn = (_hom(points2D) @ torch.linalg.inv(K).T)[:, :2]
        f = (K[0, 0] + K[1, 1]) / 2.0
        thr2 = (threshold_px / f) ** 2
        zero = xn.new_zeros(())

        Ps = _dlt_camera_matrices(xn[idx], points3D[idx])
        finite = torch.isfinite(Ps).all(-1, keepdim=True).all(-2,
                                                              keepdim=True)
        Ps = torch.where(finite, Ps, torch.zeros_like(Ps))
        # the sign that puts most of the minimal points in front
        depths = torch.einsum("sij,smj->smi", Ps, _hom(points3D[idx]))[..., 2]
        ahead = (depths > 0).sum(1, keepdim=True)
        Ps = Ps * torch.where(ahead >= MIN_PNP_POINTS // 2 + 1, 1.0,
                              -1.0)[..., None]

        r2 = _reprojection_errors(Ps, xn, points3D)
        quality = torch.where(mask[None] & torch.isfinite(r2),
                              (1.0 - r2 / thr2).clamp_min(0.0), zero)
        P = Ps[quality.sum(-1).argmax()]

        X = _hom(points3D)
        for _ in range(lo_iters):
            r2 = _reprojection_errors(P[None], xn, points3D)[0]
            w = torch.where(mask & torch.isfinite(r2),
                            (1.0 - r2 / thr2).clamp_min(0.0), zero)
            enough = (w > 0).sum() >= MIN_PNP_POINTS
            A = _weighted_dlt_rows(xn, points3D, torch.sqrt(w + 1e-12))
            P_new = solve_nullvec_fix_last(A[None])[0].reshape(3, 4)
            d = X @ P_new[2]
            flip = ((d < 0) & (w > 0)).sum() > ((d > 0) & (w > 0)).sum()
            P_new = torch.where(flip, -P_new, P_new)
            P = torch.where(enough, P_new, P)

        r2 = _reprojection_errors(P[None], xn, points3D)[0]
        inliers = (r2 < thr2) & mask
        R, t = _orthogonalize(P, xn, points3D)
    num = inliers.sum().to(torch.int32)
    return {"R": R, "t": t, "inliers": inliers, "num_inliers": num,
            "success": num >= MIN_PNP_POINTS}


def ransac_pnp(points2D, points3D, mask, K, generator, threshold_px=12.0,
               num_hypotheses=512, lo_iters=2, device="cuda"):
    """Absolute pose from padded 2D-3D correspondences; ``generator`` (a
    torch.Generator on ``device``) draws the hypotheses."""
    dev = resolve_device(device)
    points2D, points3D, K = (torch.as_tensor(a, dtype=torch.float32,
                                             device=dev)
                             for a in (points2D, points3D, K))
    mask = torch.as_tensor(mask, device=dev).bool()
    idx = sample_pnp_indices(mask, num_hypotheses, generator)
    return ransac_pnp_from_indices(idx, points2D, points3D, mask, K,
                                   threshold_px, lo_iters)
