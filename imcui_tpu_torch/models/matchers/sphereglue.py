"""SphereGlue spherical graph matcher, float32.

Counterpart of ``imcui_tpu/models/matchers/sphereglue.py``, with pairs as
a batch dimension in place of ``vmap``: keypoints lifted from
equirectangular pixels to the unit sphere (``to_sphere``), embedded with
their descriptor and score by one linear; a k-nearest-neighbour graph on
the sphere as a dense masked adjacency (``cheb_laplacian``: the scaled
Laplacian L − I of the symmetrised graph); an order-2 Chebyshev graph
convolution; two cross-attention GNN layers (one q/k/v linear, 4 heads
of contiguous channels, ``ops/attention.py::mha``, merge of [x, message],
ReLU, a linear, residual); a final projection and the log-domain
Sinkhorn of ``ops/sinkhorn.py``. Every product runs under
``layers.full_fp32``.

A neighbour is in the graph where its cosine is at least the row's
KNN-th largest (``dots >= kth``): the set can change with the last bit
of ``xyz @ xyzᵀ``, so the card and the CPU agree where the KNN-th and
the next neighbour are apart, not at an exact tie.

As in the JAX module the graph takes KNN = 20 neighbours and the
Chebyshev order is K_CHEB = 2 whatever the conf's ``knn`` and ``K`` say
(both are read and ignored), and the sizes come from ``size*``, else the
image, else the keypoints' extent plus one. No trained tree
(``sphereglue_*.pth``) is in the repository: the model runs a user's
``checkpoint_npz`` or the port's seed-0 random tree, reported in
``meta``.
"""

import math

import torch

from ...ops.attention import mha
from ...ops.sinkhorn import log_optimal_transport, matches_from_assignment
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import full_fp32, init_linear, linear, relu
from .nearest_neighbor import pair_masks, pair_sizes

K_CHEB = 2
KNN = 20
N_GNN = 2
NHEAD = 4


def init_params(gen, descriptor_dim=256, output_dim=512):
    d = output_dim
    return {
        "embed": init_linear(gen, descriptor_dim + 4, d),
        "cheb": [init_linear(gen, d, d) for _ in range(K_CHEB + 1)],
        "gnn": [{"qkv": init_linear(gen, d, 3 * d),
                 "merge": init_linear(gen, 2 * d, d),
                 "mlp": init_linear(gen, d, d)} for _ in range(N_GNN)],
        "final_proj": init_linear(gen, d, d),
        "bin_score": torch.tensor(1.0),
    }


def to_sphere(kpts, size):
    """Equirectangular pixels (B, N, 2) xy of images (B, 2) (w, h) → unit
    xyz (B, N, 3)."""
    lon = (kpts[..., 0] / size[:, None, 0] - 0.5) * 2 * math.pi
    lat = (0.5 - kpts[..., 1] / size[:, None, 1]) * math.pi
    cl = torch.cos(lat)
    return torch.stack([cl * torch.cos(lon), cl * torch.sin(lon),
                        torch.sin(lat)], -1)


def knn_adjacency(dots, knn=KNN):
    """The symmetrised k-nearest-neighbour graph (B, N, N) float32 of
    masked cosines ``dots`` (invalid pairs −2, the diagonal lowered by 3):
    j is i's neighbour where dots[i, j] is at least the row's knn-th
    largest and above −1.5."""
    k = min(knn, dots.shape[-1] - 1)
    kth = torch.topk(dots, k, dim=-1).values[..., -1:]
    adj = (dots >= kth) & (dots > -1.5)
    return (adj | adj.transpose(1, 2)).float()


def masked_dots(xyz, mask):
    """xyz · xyzᵀ (B, N, N) with invalid pairs at −2 and the diagonal
    lowered by 3."""
    n = xyz.shape[1]
    dots = xyz @ xyz.transpose(1, 2)
    dots = torch.where(mask[:, :, None] & mask[:, None, :], dots,
                       dots.new_tensor(-2.0))
    return dots - 3.0 * torch.eye(n, device=xyz.device)


def cheb_laplacian(xyz, mask, knn=KNN):
    """Dense masked kNN graph on the sphere → scaled Laplacian L − I,
    (B, N, N)."""
    adj = knn_adjacency(masked_dots(xyz, mask), knn)
    dinv = torch.rsqrt(adj.sum(-1).clamp_min(1.0))
    eye = torch.eye(adj.shape[-1], device=adj.device)
    return eye - dinv[..., :, None] * adj * dinv[..., None, :] - eye


def chebyshev(params, x, lhat):
    """Chebyshev graph convolution of order K_CHEB, then ReLU."""
    t_prev, t_cur = x, lhat @ x
    out = linear(params["cheb"][0], t_prev) + linear(params["cheb"][1],
                                                     t_cur)
    for k in range(2, K_CHEB + 1):
        t_next = 2.0 * (lhat @ t_cur) - t_prev
        out = out + linear(params["cheb"][k], t_next)
        t_prev, t_cur = t_cur, t_next
    return relu(out)


def cross_gnn(p, x, source, mask_src):
    b, n, d = x.shape

    def heads(t):
        return t.unflatten(-1, (NHEAD, d // NHEAD)).transpose(1, 2)

    qkv_x, qkv_s = linear(p["qkv"], x), linear(p["qkv"], source)
    msg = mha(heads(qkv_x[..., :d]), heads(qkv_s[..., d:2 * d]),
              heads(qkv_s[..., 2 * d:]), mask_src[:, None, None, :])
    msg = msg.transpose(1, 2).reshape(b, n, d)
    return x + linear(p["mlp"], relu(linear(p["merge"],
                                            torch.cat([x, msg], -1))))


def forward(params, kpts0, kpts1, scores0, scores1, desc0, desc1, mask0,
            mask1, size0, size1, sinkhorn_iterations=20,
            match_threshold=0.2):
    """Over a batch of B pairs: kpts (B, N, 2), scores (B, N), desc (B, N,
    D), masks (B, N) bool, sizes (B, 2) (w, h). Returns matches0 (B, N0)
    int32 and matching_scores0."""
    with full_fp32():
        x0, x1 = to_sphere(kpts0, size0), to_sphere(kpts1, size1)
        f0 = linear(params["embed"], torch.cat([desc0, x0, scores0[..., None]],
                                               -1))
        f1 = linear(params["embed"], torch.cat([desc1, x1, scores1[..., None]],
                                               -1))
        f0 = chebyshev(params, f0, cheb_laplacian(x0, mask0))
        f1 = chebyshev(params, f1, cheb_laplacian(x1, mask1))
        for p in params["gnn"]:
            f0, f1 = cross_gnn(p, f0, f1, mask1), cross_gnn(p, f1, f0, mask0)
        f0 = linear(params["final_proj"], f0)
        f1 = linear(params["final_proj"], f1)
        sim = (f0 @ f1.transpose(1, 2)) / f0.shape[-1] ** 0.25
        Z = log_optimal_transport(sim, params["bin_score"],
                                  sinkhorn_iterations, mask0, mask1)
        matches0, scores = matches_from_assignment(Z, match_threshold,
                                                   mask0, mask1)
    return {"matches0": matches0, "matching_scores0": scores}


class SphereGlue(BaseModel):
    """BaseModel wrapper: keypoints*, scores*, descriptors* (B, D, N) or
    (B, N, D), optional mask*, size* or image* → matches0,
    matching_scores0."""

    default_conf = {
        "match_threshold": 0.2,
        "sinkhorn_iterations": 20,
        "max_kpts": 20000,
        "knn": 20,
        "K": 2,
        "GNN_layers": ["cross"],
        "aggr": "add",
        "descriptor_dim": 256,
        "output_dim": 512,
        "model_name": "sphereglue_superpoint.pth",
    }
    required_inputs = ["image0", "keypoints0", "scores0", "descriptors0",
                       "image1", "keypoints1", "scores1", "descriptors1"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0),
                              conf["descriptor_dim"], conf["output_dim"]),
            "sphereglue", self.device)

    def _forward(self, data):
        dev = self.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        kpts0, kpts1 = f32(data["keypoints0"]), f32(data["keypoints1"])
        desc0, desc1 = f32(data["descriptors0"]), f32(data["descriptors1"])
        if desc0.shape[1] != kpts0.shape[1]:  # (B, D, N) → (B, N, D)
            desc0 = desc0.transpose(1, 2)
        if desc1.shape[1] != kpts1.shape[1]:
            desc1 = desc1.transpose(1, 2)
        return forward(
            self.params, kpts0, kpts1, f32(data["scores0"]),
            f32(data["scores1"]), desc0, desc1,
            *pair_masks(data, kpts0.shape[0], kpts0.shape[1],
                        kpts1.shape[1], dev),
            *pair_sizes(data, kpts0, kpts1),
            sinkhorn_iterations=int(self.conf["sinkhorn_iterations"]),
            match_threshold=float(self.conf["match_threshold"]))
