"""Batched-hypothesis RANSAC for fundamental matrices and homographies.

Counterpart of ``imcui_tpu/ops/ransac.py``, in plain float32 PyTorch
(TF32 off), batched over pairs in place of ``vmap``:

- all hypotheses are drawn at once by Gumbel top-k over the valid
  correspondences (``sample_indices``, kept apart so a test can feed the
  index set the JAX package drew);
- every minimal problem is solved in closed form (normal equations by
  unrolled Gaussian elimination with the gauge h_last = 1);
- every hypothesis is scored against every correspondence with the
  MAGSAC-style truncated quality;
- the best model is refined by iteratively reweighted least squares
  (weighted DLT / 8-point with rank-2 projection), keeping the previous
  model when fewer than the minimal number of points are inliers.
"""

import torch

from .. import resolve_device
from ..models.layers import full_fp32

NEG_INF = -1e9
LO_ITERS = 3  # local-optimisation refits of the best model


def _hom(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def normalize_points(pts, weights):
    """Weighted Hartley normalisation. pts: (B, N, 2), weights (B, N) ≥ 0.
    Returns normalised points and T (B, 3, 3) with pts_hat = T·[pts; 1]."""
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-8)
    centroid = (pts * w[..., None]).sum(-2)
    d = torch.sqrt(((pts - centroid[:, None]) ** 2).sum(-1))
    scale = 2.0 ** 0.5 / (d * w).sum(-1).clamp_min(1e-8)
    return (pts - centroid[:, None]) * scale[:, None, None], \
        _t_matrix(centroid, scale)


def _t_matrix(c, s):
    """Similarity transforms [[s,0,-s·cx],[0,s,-s·cy],[0,0,1]]; c (..., 2)."""
    z, o = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, z, -s * c[..., 0]], -1),
        torch.stack([z, s, -s * c[..., 1]], -1),
        torch.stack([z, z, o], -1)], -2)


def _smallest_eigvec(ata):
    """Eigenvector of the smallest eigenvalue of symmetric (..., 9, 9),
    solved in float64 and returned in ``ata``'s dtype. In float32,
    cuSOLVER's ``eigh`` loses the null vector of an ill-conditioned normal
    matrix that LAPACK and XLA resolve: on a planted synthetic scene the
    relative pose erred by ~4.7° on the card against < 0.3° on the CPU
    (tests/test_torch_port_cuda.py::test_pose_chain_and_pnp_on_card)."""
    return torch.linalg.eigh(ata.double())[1][..., :, 0].to(ata.dtype)


def homography_dlt(pts0, pts1, weights):
    """Weighted DLT homography, pts0 → pts1 (B, N, 2); H[2, 2] = 1."""
    p0, t0 = normalize_points(pts0, weights)
    p1, t1 = normalize_points(pts1, weights)
    x, y, u, v = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    ay = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = torch.cat([ax, ay], -2)
    w2 = torch.cat([weights, weights], -1)
    h = _smallest_eigvec((a * w2[..., None]).transpose(-1, -2) @ a)
    hm = torch.linalg.inv(t1) @ h.reshape(-1, 3, 3) @ t0
    h22 = hm[:, 2:3, 2:3]
    return hm / torch.where(h22.abs() > 1e-8, h22, torch.ones_like(h22))


def fundamental_8pt(pts0, pts1, weights):
    """Weighted 8-point fundamental matrix with rank-2 projection,
    Frobenius-normalised (sign is arbitrary)."""
    p0, t0 = normalize_points(pts0, weights)
    p1, t1 = normalize_points(pts1, weights)
    x0, y0, x1, y1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], -1)
    f = _smallest_eigvec((a * weights[..., None]).transpose(-1, -2) @ a)
    u, s, vt = torch.linalg.svd(f.reshape(-1, 3, 3))
    s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], -1)
    fm = t1.transpose(-1, -2) @ ((u * s[:, None, :]) @ vt) @ t0
    return fm / torch.linalg.matrix_norm(fm)[:, None, None].clamp_min(1e-12)


def inv3x3(m):
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca, cb, cc = e * i - f * h, c * h - b * i, b * f - c * e
    cd, ce, cf = f * g - d * i, a * i - c * g, c * d - a * f
    cg, ch, ci = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * ca + b * cd + c * cg
    adj = torch.stack([torch.stack([ca, cb, cc], -1),
                       torch.stack([cd, ce, cf], -1),
                       torch.stack([cg, ch, ci], -1)], -2)
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    return adj / det[..., None, None]


def solve_nullvec_fix_last(a, ridge=1e-8):
    """Minimal DLT system A h ≈ 0 with the gauge h_last = 1: normal
    equations solved by unrolled Gaussian elimination. a: (..., m, d+1)
    → (..., d+1)."""
    d = a.shape[-1] - 1
    bm, c = a[..., :d], a[..., d]
    m = bm.transpose(-1, -2) @ bm + ridge * torch.eye(d, device=a.device)
    rhs = -(bm.transpose(-1, -2) @ c[..., None])
    aug = torch.cat([m, rhs], -1)  # (..., d, d+1)
    for k in range(d):
        piv = aug[..., k, k:k + 1]
        piv = torch.where(piv.abs() > 1e-12, piv, torch.full_like(piv, 1e-12))
        row = aug[..., k, :] / piv
        aug = aug - aug[..., :, k:k + 1] * row[..., None, :]
        aug[..., k, :] = row
    x = aug[..., :, d]
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _normalize_batch(p):
    """Per-hypothesis Hartley normalisation of (..., m, 2)."""
    c = p.mean(-2, keepdim=True)
    s = 2.0 ** 0.5 / torch.sqrt(((p - c) ** 2).sum(-1)).mean(-1).clamp_min(1e-8)
    return (p - c) * s[..., None, None], c[..., 0, :], s


def minimal_homographies(q0, q1):
    """Batched 4-point DLT: (..., 4, 2) pairs → (..., 3, 3)."""
    n0, c0, s0 = _normalize_batch(q0)
    n1, c1, s1 = _normalize_batch(q1)
    x, y, u, v = n0[..., 0], n0[..., 1], n1[..., 0], n1[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    ay = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    h = solve_nullvec_fix_last(torch.cat([ax, ay], -2))
    hm = inv3x3(_t_matrix(c1, s1)) @ h.unflatten(-1, (3, 3)) @ _t_matrix(c0, s0)
    h22 = hm[..., 2:3, 2:3]
    return hm / torch.where(h22.abs() > 1e-8, h22, torch.ones_like(h22))


def minimal_fundamentals(q0, q1):
    """Batched 8-point solve without the rank-2 projection (the Sampson
    error of the full-rank F ranks hypotheses as well; the refit
    projects): (..., 8, 2) pairs → (..., 3, 3), Frobenius-normalised."""
    n0, c0, s0 = _normalize_batch(q0)
    n1, c1, s1 = _normalize_batch(q1)
    x0, y0, x1, y1 = n0[..., 0], n0[..., 1], n1[..., 0], n1[..., 1]
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], -1)
    fn = solve_nullvec_fix_last(a).unflatten(-1, (3, 3))
    f = _t_matrix(c1, s1).transpose(-1, -2) @ fn @ _t_matrix(c0, s0)
    norm = torch.sqrt((f * f).sum((-2, -1), keepdim=True))
    return f / norm.clamp_min(1e-12)


def homography_errors(h, pts0, pts1):
    """Symmetric transfer error (px²) of every model: h (B, S, 3, 3),
    pts (B, N, 2) → (B, S, N)."""
    def proj(m, p):
        q = torch.einsum("bsij,bnj->bsni", m, _hom(p))
        z = q[..., 2:]
        return q[..., :2] / torch.where(z.abs() > 1e-8, z,
                                        torch.full_like(z, 1e-8))

    e01 = ((proj(h, pts0) - pts1[:, None]) ** 2).sum(-1)
    e10 = ((proj(inv3x3(h), pts1) - pts0[:, None]) ** 2).sum(-1)
    return 0.5 * (e01 + e10)


def sampson_errors(f, pts0, pts1):
    """First-order epipolar (Sampson) error (px²) of every model:
    f (B, S, 3, 3), pts (B, N, 2) → (B, S, N)."""
    p0, p1 = _hom(pts0), _hom(pts1)
    fp0 = torch.einsum("bsij,bnj->bsni", f, p0)
    ftp1 = torch.einsum("bsji,bnj->bsni", f, p1)
    num = (p1[:, None] * fp0).sum(-1) ** 2
    den = fp0[..., 0] ** 2 + fp0[..., 1] ** 2 + ftp1[..., 0] ** 2 \
        + ftp1[..., 1] ** 2
    return num / den.clamp_min(1e-12)


_SOLVERS = {
    # refit solver, minimal solver, batched residual, minimal size
    "homography": (homography_dlt, minimal_homographies, homography_errors, 4),
    "fundamental": (fundamental_8pt, minimal_fundamentals, sampson_errors, 8),
}


def minimal_size(model):
    """Correspondences in one minimal sample of ``model``."""
    return _SOLVERS[model][3]


def sample_indices(mask, num_hypotheses, k, generator):
    """Gumbel top-k sampling without replacement from the valid slots.
    mask: (B, N) bool → (B, S, k) int64 indices."""
    b, n = mask.shape
    u = torch.rand((b, num_hypotheses, n), generator=generator,
                   device=mask.device).clamp_min(torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    g = torch.where(mask[:, None, :], g, g.new_tensor(NEG_INF))
    return torch.topk(g, k, dim=-1).indices


def ransac_from_indices(idx, pts0, pts1, mask, model="fundamental",
                        threshold=8.0):
    """RANSAC core on a given hypothesis index set idx (B, S, k).
    pts0/pts1: (B, N, 2) padded correspondences; mask: (B, N) validity.
    Returns M (B, 3, 3), inliers (B, N), num_inliers (B,), score (B,)."""
    refit, minimal, errors, k_min = _SOLVERS[model]
    thr2 = threshold ** 2
    with full_fp32():
        q0 = torch.gather(pts0[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, 2))
        q1 = torch.gather(pts1[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, 2))
        ms = minimal(q0, q1)                                  # (B, S, 3, 3)
        finite = torch.isfinite(ms).all(-1, keepdim=True).all(-2, keepdim=True)
        ms = torch.where(finite, ms, torch.zeros_like(ms))
        r2 = errors(ms, pts0, pts1)                           # (B, S, N)
        zero = r2.new_zeros(())
        quality = torch.where(mask[:, None], (1.0 - r2 / thr2).clamp_min(0.0),
                              zero)
        best = quality.sum(-1).argmax(-1)
        m = ms[torch.arange(ms.shape[0], device=ms.device), best]

        def residual(m):
            return errors(m[:, None], pts0, pts1)[:, 0]

        for _ in range(LO_ITERS):
            w = torch.where(mask, (1.0 - residual(m) / thr2).clamp_min(0.0),
                            zero)
            enough = ((w > 0).sum(-1) >= k_min)[:, None, None]
            m = torch.where(enough, refit(pts0, pts1, w + 1e-12), m)

        r2 = residual(m)
        inliers = (r2 < thr2) & mask
        score = torch.where(mask, (1.0 - r2 / thr2).clamp_min(0.0),
                            zero).sum(-1)
    return {"M": m, "inliers": inliers,
            "num_inliers": inliers.sum(-1).to(torch.int32), "score": score}


def ransac(pts0, pts1, mask, generator, model="fundamental", threshold=8.0,
           num_hypotheses=1024, device="cuda"):
    """Batched-hypothesis RANSAC over a batch of pairs: pts0/pts1 (B, N,
    2), mask (B, N). ``generator`` (a torch.Generator on ``device``) draws
    the hypotheses."""
    dev = resolve_device(device)
    pts0 = torch.as_tensor(pts0, dtype=torch.float32, device=dev)
    pts1 = torch.as_tensor(pts1, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev).bool()
    idx = sample_indices(mask, num_hypotheses, minimal_size(model), generator)
    return ransac_from_indices(idx, pts0, pts1, mask, model, threshold)


def ransac_batch(pts0, pts1, mask, generator, **kwargs):
    """RANSAC over a leading batch of pairs, pts*: (B, N, 2): the JAX
    package's public name (its vmap over split keys), with ``generator`` in
    place of the key. ``ransac`` is batched already, so this is it."""
    return ransac(pts0, pts1, mask, generator, **kwargs)
