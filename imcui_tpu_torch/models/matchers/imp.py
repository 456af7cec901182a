"""IMP (iterative matching and pose estimation) sparse matcher, float32.

Counterpart of ``imcui_tpu/models/matchers/imp.py``, with pairs as a
batch dimension in place of ``vmap``: keypoints (normalised, with their
score) and descriptors encoded to 256 channels, then six attention
layers, self and cross in turn (``attn_layer``: one shared q/k/v linear,
4 heads of contiguous channels, ``ops/attention.py::mha``, an MLP over
[x, message] with ReLU, residual). After layers 2 and 4 a pose step: the
soft assignment of view 0's keypoints, a weighted 8-point fundamental
matrix from all of them (``weighted_eight_point``), and the Sampson
distance of every candidate pair under it, whose −epi_scale·sqrt enters
the next cross-attention as an additive bias (``mha(bias=)``). Then the
log-domain Sinkhorn of ``ops/sinkhorn.py``.

Every product runs under ``layers.full_fp32`` (the JAX function's
``@highest_precision``), and the 9 × 9 ``eigh`` of the 8-point solve in
float64: cuSOLVER's float32 ``eigh`` can lose the null vector of an
ill-conditioned normal matrix. F's sign is free: the Sampson distance is
even in F.

Descriptors that are not 128-d pass through a fixed random (D, 128)
projection scaled by 1/sqrt(D). The JAX module draws it with
``jax.random.normal(PRNGKey(7), …)``, which torch cannot replay; this
module draws its own from a torch generator seeded 7, kept per width in
``self._proj`` (where a test puts the JAX package's). SFD2's 128-d
descriptors need none. No trained tree (``imp_gml.920.pth``) is in the
repository: the model runs a user's ``checkpoint_npz`` or the port's
seed-0 random tree, reported in ``meta``.
"""

import torch

from ...ops.attention import mha
from ...ops.sinkhorn import log_optimal_transport, matches_from_assignment
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import full_fp32, init_linear, linear, relu
from .nearest_neighbor import pair_masks, pair_sizes

D_MODEL = 256
N_LAYERS = 6
POSE_AT = (2, 4)  # the pose step runs after these layers
NHEAD = 4
DESC_DIM = 128
PROJECTION_SEED = 7


def init_params(gen, descriptor_dim=DESC_DIM):
    return {
        "kenc": {"0": init_linear(gen, 3, 64),
                 "1": init_linear(gen, 64, D_MODEL)},
        "denc": init_linear(gen, descriptor_dim, D_MODEL),
        "layers": [{"qkv": init_linear(gen, D_MODEL, 3 * D_MODEL),
                    "mlp": {"0": init_linear(gen, 2 * D_MODEL, 2 * D_MODEL),
                            "2": init_linear(gen, 2 * D_MODEL, D_MODEL)}}
                   for _ in range(N_LAYERS)],
        "bin_score": torch.tensor(1.0),
        "epi_scale": torch.tensor(1.0),
    }


def weighted_eight_point(p0, p1, w):
    """Weighted 8-point F from all correspondences, (B, 3, 3): the null
    vector of the weighted 9 × 9 normal matrix, solved in float64. p0/p1
    (B, N, 2) normalised coordinates; w (B, N) ≥ 0."""
    x0, y0 = p0.unbind(-1)
    x1, y1 = p1.unbind(-1)
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], -1)
    ata = (a * w[..., None]).transpose(1, 2) @ a
    vec = torch.linalg.eigh(ata.double())[1][..., :, 0]
    return vec.to(p0.dtype).reshape(-1, 3, 3)


def sampson_pairs(f, p0, p1):
    """Sampson distance of every pair (i, j) of p0 (B, N0, 2) and p1 (B,
    N1, 2) under F (B, 3, 3) → (B, N0, N1)."""
    h0 = torch.cat([p0, torch.ones_like(p0[..., :1])], -1)
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    fx0 = h0 @ f.transpose(1, 2)   # F·x0, (B, N0, 3)
    ftx1 = h1 @ f                  # Fᵀ·x1, (B, N1, 3)
    num = (fx0 @ h1.transpose(1, 2)) ** 2
    den = (fx0[..., 0] ** 2 + fx0[..., 1] ** 2)[..., :, None] \
        + (ftx1[..., 0] ** 2 + ftx1[..., 1] ** 2)[..., None, :]
    return num / den.clamp_min(1e-9)


def attn_layer(p, x, source, mask_src, bias=None):
    """x (B, N, D) attends to source (B, M, D); mask_src (B, M); bias
    (B, 1, N, M) or None, shared by the heads."""
    b, n, d = x.shape

    def heads(t):
        return t.unflatten(-1, (NHEAD, d // NHEAD)).transpose(1, 2)

    kv = linear(p["qkv"], source)
    q = heads(linear(p["qkv"], x)[..., :d])
    k, v = heads(kv[..., d:2 * d]), heads(kv[..., 2 * d:])
    msg = mha(q, k, v, mask_src[:, None, None, :], bias)
    msg = msg.transpose(1, 2).reshape(b, n, d)
    return x + linear(p["mlp"]["2"], relu(linear(
        p["mlp"]["0"], torch.cat([x, msg], -1))))


def epipolar_gate(params, f0, f1, mask0, mask1, p0n, p1n):
    """The pose step: soft assignment → weighted 8-point F → −epi_scale ·
    sqrt(Sampson) of every pair, (B, N0, N1)."""
    sim = (f0 @ f1.transpose(1, 2)) / D_MODEL ** 0.5
    sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim,
                      sim.new_tensor(-1e9))
    p01 = torch.softmax(sim, 2)
    w = p01.amax(2) * mask0
    fmat = weighted_eight_point(p0n, p01 @ p1n, w)
    return -params["epi_scale"] * torch.sqrt(
        sampson_pairs(fmat, p0n, p1n) + 1e-9)


def forward(params, kpts0, kpts1, scores0, scores1, desc0, desc1, mask0,
            mask1, size0, size1, sinkhorn_iterations=20,
            match_threshold=0.2):
    """Over a batch of B pairs: kpts (B, N, 2), scores (B, N), desc (B, N,
    128), masks (B, N) bool, sizes (B, 2) (w, h). Returns matches0 (B,
    N0) int32 and matching_scores0."""
    with full_fp32():
        def norm(kpts, size):
            return (kpts - size[:, None] / 2) / size.amax(-1)[:, None, None]

        def enc(pn, s, d):
            k = linear(params["kenc"]["1"], relu(linear(
                params["kenc"]["0"], torch.cat([pn, s[..., None]], -1))))
            return k + linear(params["denc"], d)

        p0n, p1n = norm(kpts0, size0), norm(kpts1, size1)
        f0, f1 = enc(p0n, scores0, desc0), enc(p1n, scores1, desc1)
        bias01 = bias10 = None
        for i, layer in enumerate(params["layers"]):
            if i % 2 == 0:
                f0 = attn_layer(layer, f0, f0, mask0)
                f1 = attn_layer(layer, f1, f1, mask1)
            else:
                f0, f1 = (attn_layer(layer, f0, f1, mask1, bias01),
                          attn_layer(layer, f1, f0, mask0, bias10))
            if i in POSE_AT:
                gate = epipolar_gate(params, f0, f1, mask0, mask1, p0n, p1n)
                bias01, bias10 = gate[:, None], gate.transpose(1, 2)[:, None]
        sim = (f0 @ f1.transpose(1, 2)) / D_MODEL ** 0.25
        Z = log_optimal_transport(sim, params["bin_score"],
                                  sinkhorn_iterations, mask0, mask1)
        matches0, scores = matches_from_assignment(Z, match_threshold,
                                                   mask0, mask1)
    return {"matches0": matches0, "matching_scores0": scores}


class IMP(BaseModel):
    """BaseModel wrapper: keypoints*, scores*, descriptors* (B, D, N) or
    (B, N, D), optional mask*, size* or image* → matches0,
    matching_scores0."""

    default_conf = {
        "match_threshold": 0.2,
        "features": "sfd2",
        "model_name": "imp_gml.920.pth",
        "sinkhorn_iterations": 20,
    }
    required_inputs = ["image0", "keypoints0", "scores0", "descriptors0",
                       "image1", "keypoints1", "scores1", "descriptors1"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "imp",
            self.device)
        self._proj = {}

    def projection(self, dd):
        """The (dd, 128) projection of dd-wide descriptors."""
        if dd not in self._proj:
            gen = torch.Generator().manual_seed(PROJECTION_SEED)
            self._proj[dd] = (torch.randn((dd, DESC_DIM), generator=gen)
                              / dd ** 0.5).to(self.device)
        return self._proj[dd]

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
        dd = desc0.shape[-1]
        if dd != DESC_DIM:
            proj = torch.as_tensor(self.projection(dd), dtype=torch.float32,
                                   device=dev)
            with full_fp32():
                desc0, desc1 = desc0 @ proj, desc1 @ proj
        return forward(
            self.params, kpts0, kpts1, f32(data["scores0"]),
            f32(data["scores1"]), desc0, desc1,
            *pair_masks(data, kpts0.shape[0], kpts0.shape[1],
                        kpts1.shape[1], dev),
            *pair_sizes(data, kpts0, kpts1),
            sinkhorn_iterations=int(self.conf["sinkhorn_iterations"]),
            match_threshold=float(self.conf["match_threshold"]))
