"""AdaLAM, the hand-crafted outlier filter (adaptive locally-affine
matching). Counterpart of ``imcui_tpu/models/matchers/adalam.py``:
mutual nearest-neighbour matches under the ratio test (0.95,
``ops/matching.py::mutual_nn_match``) are filtered by local affine
consistency around spatially spread seed matches.

Fixed shapes as in the JAX module: ``num_seeds`` seeds by one round of
confidence top-k over neighbour-suppressed scores, every (seed, match)
pair scored in one (S, N) residual matrix, a match kept when a seed with
enough support explains it. Pairs are a batch dimension. The seeds come
from ``torch.topk`` where the JAX module takes ``lax.top_k``: equal
scores may fill the slots in another order, so tests compare the
surviving match sets, not slot order. The products run under
``layers.full_fp32``. The filter has no parameters.
"""

import torch

from ...ops.matching import mutual_nn_match
from ...utils.base_model import BaseModel
from ..layers import full_fp32
from .nearest_neighbor import descriptor_inputs, pair_sizes


def _fit_local_affine(k0, k1, w):
    """Weighted least-squares affine A, b with k1 ≈ k0 @ A + b, in closed
    form (normal equations and a 2 × 2 inverse). k0, k1: (..., N, 2); w:
    (..., N), broadcast against each other. Returns A (..., 2, 2) and b
    (..., 2)."""
    wsum = w.sum(-1).clamp_min(1e-8)[..., None]
    mu0 = (k0 * w[..., None]).sum(-2) / wsum
    mu1 = (k1 * w[..., None]).sum(-2) / wsum
    c0 = k0 - mu0[..., None, :]
    c1 = k1 - mu1[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", c0 * w[..., None], c1)
    var = torch.einsum("...ni,...nj->...ij", c0 * w[..., None], c0) \
        + 1e-6 * torch.eye(2, device=w.device)
    det = var[..., 0, 0] * var[..., 1, 1] - var[..., 0, 1] * var[..., 1, 0]
    inv = torch.stack([torch.stack([var[..., 1, 1], -var[..., 0, 1]], -1),
                       torch.stack([-var[..., 1, 0], var[..., 0, 0]], -1)],
                      -2)
    inv = inv / torch.where(det.abs() > 1e-12, det, 1e-12)[..., None, None]
    A = inv @ cov
    b = mu1 - torch.einsum("...i,...ij->...j", mu0, A)
    return A, b


def adalam_filter(kpts0, kpts1, matches0, scores0, mask0, num_seeds=64,
                  seed_radius=0.15, residual_threshold=0.1, min_support=6):
    """Filter nearest-neighbour matches by local affine consistency.

    kpts0 (B, N0, 2), kpts1 (B, N1, 2), normalised to [0, 1] by the
    caller; matches0 (B, N0) int indices into kpts1; scores0 (B, N0);
    mask0 (B, N0). Returns the refined matches0 (outliers -1) and the
    keep mask."""
    valid = (matches0 > -1) & mask0
    mk1 = torch.gather(
        kpts1, 1,
        matches0.long().clamp(0, kpts1.shape[1] - 1)[..., None].expand(
            -1, -1, 2))
    with full_fp32():
        # seeds: confidence top-k after one round of suppression by a
        # stronger valid match within seed_radius
        d00 = torch.linalg.vector_norm(
            kpts0[:, :, None] - kpts0[:, None, :], dim=-1)
        stronger = (scores0[:, None, :] > scores0[:, :, None]) \
            & (d00 < seed_radius) & valid[:, None, :]
        suppressed = stronger.any(-1)
        seed_scores = torch.where(valid & ~suppressed, scores0, -1.0)
        top, seed_idx = torch.topk(seed_scores, num_seeds, dim=-1)
        seed_ok = top > 0
        s0 = torch.gather(kpts0, 1, seed_idx[..., None].expand(-1, -1, 2))
        # neighbourhood weights of each seed over every match
        dist = torch.linalg.vector_norm(kpts0[:, None] - s0[:, :, None],
                                        dim=-1)  # (B, S, N0)
        nbr_w = torch.exp(-(dist / seed_radius) ** 2) * valid[:, None, :]
        A, b = _fit_local_affine(kpts0[:, None], mk1[:, None], nbr_w)
        pred = kpts0[:, None] @ A + b[..., None, :]
        residuals = torch.linalg.vector_norm(pred - mk1[:, None], dim=-1)
    consistent = (residuals < residual_threshold) & valid[:, None, :] \
        & (nbr_w > 0.1)
    support = consistent.sum(-1)
    good_seed = seed_ok & (support >= min_support)
    keep = (consistent & good_seed[..., None]).any(-2)
    return torch.where(keep, matches0, -1), keep


class AdaLAM(BaseModel):
    """BaseModel wrapper: keypoints*, descriptors* (B, D, N) and optional
    mask*, size* or image* → matches0, matching_scores0."""

    default_conf = {
        "num_seeds": 64,
        "min_support": 6,
    }
    required_inputs = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
    ]

    def _init(self, conf):
        self.meta = {"pretrained": True}  # hand-crafted

    def _forward(self, data):
        kpts0, kpts1 = (torch.as_tensor(data[k], dtype=torch.float32,
                                        device=self.device)
                        for k in ("keypoints0", "keypoints1"))
        desc0, desc1, mask0, mask1 = descriptor_inputs(data, self.device)
        nn = mutual_nn_match(desc0, desc1, mask0, mask1, ratio_thresh=0.95)
        size0, size1 = pair_sizes(data, kpts0, kpts1)
        k0n = kpts0 / size0.clamp_min(1.0)[:, None]
        k1n = kpts1 / size1.clamp_min(1.0)[:, None]
        matches0, keep = adalam_filter(
            k0n, k1n, nn["matches0"], nn["matching_scores0"], mask0,
            num_seeds=int(self.conf["num_seeds"]),
            min_support=int(self.conf["min_support"]))
        return {"matches0": matches0,
                "matching_scores0": torch.where(
                    keep, nn["matching_scores0"], 0.0)}
