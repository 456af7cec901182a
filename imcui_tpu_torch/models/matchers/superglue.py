"""SuperGlue attentional GNN matcher, float32.

Counterpart of ``imcui_tpu/models/matchers/superglue.py``: a keypoint
encoder (an MLP of 1 × 1 convolutions over (x, y, score), BatchNorm in
inference and ReLU between), ``gnn_layers`` attentional propagation
layers alternating self and cross, a final projection, and the
log-domain Sinkhorn assignment with a learnable dustbin score
(``ops/sinkhorn.py``). Pairs are a batch dimension in place of ``vmap``;
padded keypoint slots carry a key mask and zero transport mass.

The attention is the plain masked product ``ops/attention.py::mha``
(the JAX module runs an einsum, no Pallas kernel), under
``layers.full_fp32`` like every product here, so that TF32 does not move
the float32 path on the card. Heads take contiguous channel blocks, as in
the JAX module.

No trained SuperGlue tree is in the repository: the model runs the
``checkpoint_npz`` a user names (a ``save_tree_npz`` tree of the JAX
package's layout) or the port's own seed-0 random tree, which the
start-up log reports through ``meta``. The upstream ``.pth`` conversion
waits for such a file.
"""

import torch

from ...ops.attention import mha
from ...ops.sinkhorn import log_optimal_transport, matches_from_assignment
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import full_fp32, init_bn, init_linear, linear
from .nearest_neighbor import pair_masks, pair_sizes

KENC_CHANNELS = [3, 32, 64, 128, 256]


def init_mlp(gen, channels):
    """MLP of 1 × 1 convolutions with BN + ReLU between; keys are the
    torch Sequential's indices (conv at 3i, BN at 3i + 1)."""
    p = {}
    idx = 0
    for i in range(1, len(channels)):
        p[str(idx)] = init_linear(gen, channels[i - 1], channels[i])
        idx += 1
        if i < len(channels) - 1:
            p[str(idx)] = init_bn(channels[i])
            idx += 2  # BN, ReLU (no parameters)
    return p


def _bn_tokens(p, x, eps=1e-5):
    """Inference batch norm over the last dim of (..., N, C) tokens."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] \
        + p["bias"]


def mlp_apply(p, x, channels):
    idx = 0
    for i in range(1, len(channels)):
        x = linear(p[str(idx)], x)
        idx += 1
        if i < len(channels) - 1:
            x = torch.relu(_bn_tokens(p[str(idx)], x))
            idx += 2
    return x


def init_params(gen, conf):
    """Random tree in torch layout with the JAX ``init_params``'s keys."""
    dim = conf["descriptor_dim"]
    params = {
        "kenc": {"encoder": init_mlp(gen, KENC_CHANNELS + [dim])},
        "gnn": {"layers": []},
        "final_proj": init_linear(gen, dim, dim),
        "bin_score": torch.tensor(1.0),
    }
    for _ in range(conf["gnn_layers"]):
        params["gnn"]["layers"].append({
            "attn": {"merge": init_linear(gen, dim, dim),
                     "proj": {str(j): init_linear(gen, dim, dim)
                              for j in range(3)}},
            "mlp": init_mlp(gen, [2 * dim, 2 * dim, dim]),
        })
    return params


def normalize_keypoints(kpts, size_wh):
    """SuperGlue's convention: centre, then scale by 0.7 · the longer side.
    kpts (B, N, 2); size_wh (B, 2)."""
    size = size_wh.float()
    center = size / 2.0
    scaling = size.amax(-1, keepdim=True) * 0.7
    return (kpts - center[:, None]) / scaling[:, None]


def _heads(x, num_heads):
    """(B, N, D) → (B, H, N, D/H), head h on channels h·D/H onwards."""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def attn_propagation(p, x, source, mask_src, num_heads):
    """One message: attention of ``x`` over ``source`` (key mask
    ``mask_src`` (B, N_src)), merged, then the MLP on [x, message]."""
    proj = p["attn"]["proj"]
    q = _heads(linear(proj["0"], x), num_heads)
    k = _heads(linear(proj["1"], source), num_heads)
    v = _heads(linear(proj["2"], source), num_heads)
    message = linear(p["attn"]["merge"],
                     _merge_heads(mha(q, k, v, mask_src[:, None, None, :])))
    dim = x.shape[-1]
    return mlp_apply(p["mlp"], torch.cat([x, message], -1),
                     [2 * dim, 2 * dim, dim])


def log_assignment(params, kpts0, kpts1, scores0, scores1, desc0, desc1,
                   mask0, mask1, size0, size1, num_heads, iters):
    """The (B, N0+1, N1+1) log assignment of a batch of pairs. kpts (B, N,
    2), scores (B, N), desc (B, N, D), masks (B, N) bool, sizes (B, 2)."""
    with full_fp32():
        enc = params["kenc"]["encoder"]
        channels = KENC_CHANNELS + [desc0.shape[-1]]
        x0 = desc0 + mlp_apply(enc, torch.cat(
            [normalize_keypoints(kpts0, size0), scores0[..., None]], -1),
            channels)
        x1 = desc1 + mlp_apply(enc, torch.cat(
            [normalize_keypoints(kpts1, size1), scores1[..., None]], -1),
            channels)
        for i, layer in enumerate(params["gnn"]["layers"]):
            if i % 2 == 0:  # self
                d0 = attn_propagation(layer, x0, x0, mask0, num_heads)
                d1 = attn_propagation(layer, x1, x1, mask1, num_heads)
            else:  # cross
                d0 = attn_propagation(layer, x0, x1, mask1, num_heads)
                d1 = attn_propagation(layer, x1, x0, mask0, num_heads)
            x0, x1 = x0 + d0, x1 + d1
        m0 = linear(params["final_proj"], x0)
        m1 = linear(params["final_proj"], x1)
        sim = torch.einsum("bnd,bmd->bnm", m0, m1) / m0.shape[-1] ** 0.5
        return log_optimal_transport(sim, params["bin_score"], iters,
                                     mask0=mask0, mask1=mask1)


def forward_pair(params, kpts0, kpts1, scores0, scores1, desc0, desc1,
                 mask0, mask1, size0, size1, conf):
    """matches0 and matching_scores0 of a batch of pairs (the arguments as
    ``log_assignment``'s)."""
    Z = log_assignment(params, kpts0, kpts1, scores0, scores1, desc0, desc1,
                       mask0, mask1, size0, size1, conf["num_heads"],
                       int(conf["sinkhorn_iterations"]))
    matches0, mscores0 = matches_from_assignment(
        Z, float(conf["match_threshold"]), mask0=mask0, mask1=mask1)
    return {"matches0": matches0, "matching_scores0": mscores0}


class SuperGlue(BaseModel):
    """BaseModel wrapper: keypoints*, scores*, descriptors* (B, D, N) and
    optional mask*, size* or image* → matches0, matching_scores0."""

    default_conf = {
        "weights": "outdoor",
        "descriptor_dim": 256,
        "num_heads": 4,
        "gnn_layers": 18,  # 9 × (self + cross)
        "sinkhorn_iterations": 50,
        "match_threshold": 0.2,
    }
    required_inputs = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
        "scores0", "scores1",
    ]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0), conf),
            "superglue", self.device)

    def inputs(self, data):
        """The arguments of ``log_assignment`` from a matcher's input dict,
        on the model's device; the image sizes fall back as in the JAX
        module: ``size*``, else the (padded) image's (w, h), else the
        keypoints' extent plus one."""
        dev = self.device

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        kpts0, kpts1 = f32(data["keypoints0"]), f32(data["keypoints1"])
        desc0, desc1 = f32(data["descriptors0"]), f32(data["descriptors1"])
        if desc0.shape[1] != kpts0.shape[1]:  # (B, D, N) → (B, N, D)
            desc0 = desc0.transpose(1, 2)
        if desc1.shape[1] != kpts1.shape[1]:
            desc1 = desc1.transpose(1, 2)
        return (self.params, kpts0, kpts1, f32(data["scores0"]),
                f32(data["scores1"]), desc0, desc1,
                *pair_masks(data, kpts0.shape[0], kpts0.shape[1],
                            kpts1.shape[1], dev),
                *pair_sizes(data, kpts0, kpts1))

    def log_assignment(self, data):
        """The (B, N0+1, N1+1) log assignment ``forward`` decodes."""
        return log_assignment(*self.inputs(data), self.conf["num_heads"],
                              int(self.conf["sinkhorn_iterations"]))

    def _forward(self, data):
        return forward_pair(*self.inputs(data), conf=self.conf)
