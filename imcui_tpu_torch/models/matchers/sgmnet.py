"""SGMNet seeded graph matcher, float32.

Counterpart of ``imcui_tpu/models/matchers/sgmnet.py``, with pairs as a
batch dimension in place of ``vmap``: descriptors and normalised
keypoints embedded by one linear; ``seed_top_k`` seed matches chosen by
``select_seeds``; then ``layer_num`` rounds of a pooling block (the
seeds, both views' seed features summed, attend to both full sets), a
seed block (the seeds attend to themselves) and an unpooling block (each
full set attends to the seeds), each an ``attn_block`` (linear q/k/v
over 4 heads, ``ops/attention.py::mha``, merge, LayerNorm, an MLP with
exact-erf GELU over [x, message], LayerNorm, residual); a final
projection, and the log-domain Sinkhorn of ``ops/sinkhorn.py``. Every
product runs under ``layers.full_fp32``.

``select_seeds`` reproduces ``lax.top_k``'s order: among equal seeding
confidences the lowest index comes first. Every row that is not a mutual
nearest neighbour scores NEG_INF, so when fewer than ``seed_top_k``
mutual seeds exist the rest are the lowest such rows; ``torch.topk``
promises no order among ties, so a stable descending sort chooses here.

As in the JAX module the image sizes come from ``size*`` or else the
keypoints' extent plus one (never from the image), ``seed_top_k`` may
be a list (its first entry is taken) and ``seed_radius_coe`` is read and
unused. No trained tree (``sgmnet_root.pth``) is in the repository: the
model runs a user's ``checkpoint_npz`` or the port's seed-0 random tree,
reported in ``meta``.
"""

import torch

from ...ops.attention import NEG_INF, mha
from ...ops.sinkhorn import log_optimal_transport, matches_from_assignment
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (full_fp32, gelu, init_layer_norm, init_linear,
                      layer_norm, linear)
from .nearest_neighbor import pair_masks

NUM_HEADS = 4


def init_block(gen, dim):
    return {
        "q_proj": init_linear(gen, dim, dim),
        "k_proj": init_linear(gen, dim, dim),
        "v_proj": init_linear(gen, dim, dim),
        "merge": init_linear(gen, dim, dim),
        "norm1": init_layer_norm(dim),
        "mlp": {"0": init_linear(gen, 2 * dim, 2 * dim),
                "2": init_linear(gen, 2 * dim, dim)},
        "norm2": init_layer_norm(dim),
    }


def init_params(gen, conf):
    dim, n = conf["net_channels"], conf["layer_num"]
    return {
        "input_proj": init_linear(gen, conf["descriptor_dim"] + 2, dim),
        "pool_blocks": [init_block(gen, dim) for _ in range(n)],
        "unpool_blocks": [init_block(gen, dim) for _ in range(n)],
        "seed_blocks": [init_block(gen, dim) for _ in range(n)],
        "final_proj": init_linear(gen, dim, dim),
        "bin_score": torch.tensor(1.0),
    }


def attn_block(p, x, source, mask_src=None):
    """x (B, N, D) attends to source (B, M, D) over NUM_HEADS heads of
    contiguous channels; mask_src (B, M) bool."""
    b, n, d = x.shape

    def heads(t):
        return t.unflatten(-1, (NUM_HEADS, d // NUM_HEADS)).transpose(1, 2)

    q = heads(linear(p["q_proj"], x))
    k = heads(linear(p["k_proj"], source))
    v = heads(linear(p["v_proj"], source))
    mask = None if mask_src is None else mask_src[:, None, None, :]
    msg = mha(q, k, v, mask).transpose(1, 2).reshape(b, n, d)
    msg = layer_norm(p["norm1"], linear(p["merge"], msg))
    h = linear(p["mlp"]["2"], gelu(linear(p["mlp"]["0"],
                                          torch.cat([x, msg], -1))))
    return x + layer_norm(p["norm2"], h)


def _top_lowest_first(x, k):
    """Indices of the k largest entries of each row, ties to the lowest
    index first (``lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def select_seeds(desc0, desc1, mask0, mask1, k):
    """Seeds: the mutual nearest neighbours of view 0's valid rows ranked
    by the margin between a row's two best similarities. desc: (B, N, D);
    → seed0, seed1 (B, k) int64."""
    sim = torch.matmul(desc0, desc1.transpose(1, 2))
    sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim,
                      sim.new_tensor(NEG_INF))
    idx2 = _top_lowest_first(sim, 2)
    top2 = sim.gather(-1, idx2)
    ratio_conf = top2[..., 0] - top2[..., 1]
    nn10 = sim.argmax(1)  # (B, N1): the first maximal row of each column
    rows = torch.arange(sim.shape[1], device=sim.device)
    mutual = rows == nn10.gather(1, idx2[..., 0])
    conf = torch.where(mutual & mask0, ratio_conf,
                       ratio_conf.new_tensor(NEG_INF))
    seed0 = _top_lowest_first(conf, k)
    return seed0, idx2[..., 0].gather(1, seed0)


def _take(x, idx):
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def forward_pair(params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0,
                 size1, seed_top_k, sinkhorn_iterations, match_threshold):
    """Over a batch of B pairs. kpts (B, N, 2); desc (B, N, D); masks
    (B, N) bool; sizes (B, 2) (w, h). Returns matches0 (B, N0) int32 and
    matching_scores0."""
    with full_fp32():
        def embed(kpts, desc, size):
            k = (kpts - size[:, None] / 2.0) / size.amax(-1).clamp_min(
                1.0)[:, None, None]
            return linear(params["input_proj"], torch.cat([desc, k], -1))

        x0, x1 = embed(kpts0, desc0, size0), embed(kpts1, desc1, size1)
        s0, s1 = select_seeds(desc0, desc1, mask0, mask1, seed_top_k)
        both = torch.cat([mask0, mask1], 1)
        for pb, ub, sb in zip(params["pool_blocks"], params["unpool_blocks"],
                              params["seed_blocks"]):
            seeds = _take(x0, s0) + _take(x1, s1)
            seeds = attn_block(pb, seeds, torch.cat([x0, x1], 1), both)
            seeds = attn_block(sb, seeds, seeds)
            x0 = attn_block(ub, x0, seeds)
            x1 = attn_block(ub, x1, seeds)
        m0 = linear(params["final_proj"], x0)
        m1 = linear(params["final_proj"], x1)
        sim = torch.matmul(m0, m1.transpose(1, 2)) / m0.shape[-1] ** 0.5
        Z = log_optimal_transport(sim, params["bin_score"],
                                  sinkhorn_iterations, mask0, mask1)
        matches0, scores0 = matches_from_assignment(Z, match_threshold,
                                                    mask0, mask1)
    return {"matches0": matches0, "matching_scores0": scores0}


class SGMNet(BaseModel):
    """BaseModel wrapper: keypoints*, descriptors* (B, D, N) or (B, N, D),
    optional mask* and size* → matches0, matching_scores0."""

    default_conf = {
        "descriptor_dim": 128,
        "net_channels": 128,
        "layer_num": 4,
        "seed_top_k": 128,
        "seed_radius_coe": 0.01,
        "sinkhorn_iterations": 30,
        "match_threshold": 0.2,
    }
    required_inputs = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
    ]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0), conf),
            "sgmnet", self.device)

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
        mask0, mask1 = pair_masks(data, kpts0.shape[0], kpts0.shape[1],
                                  kpts1.shape[1], dev)
        size0, size1 = (f32(data[k]) if k in data else kp.amax(1) + 1.0
                        for k, kp in (("size0", kpts0), ("size1", kpts1)))
        top_k = self.conf["seed_top_k"]
        if isinstance(top_k, (list, tuple)):
            top_k = top_k[0]
        return forward_pair(
            self.params, kpts0, kpts1, desc0, desc1, mask0, mask1, size0,
            size1, int(top_k), int(self.conf["sinkhorn_iterations"]),
            float(self.conf["match_threshold"]))
