"""MicKey, metric keypoints with a relative pose. Counterpart of
``imcui_tpu/models/matchers/mickey.py``.

Each view goes alone through a four-layer conv/BN/ReLU trunk that pools
after each of its first three layers (to 1/8), then four 1 × 1 heads per
cell: a 2-D offset (tanh, ±4 px) from the cell's centre, a metric depth
(softplus + 0.1), a score (sigmoid) and a 128-d descriptor. Keypoints
lift to camera-frame 3-D points with the published default intrinsics
(f = 0.7·max(w, h), principal point at the centre). Matching is the
mutual check of a dual softmax (temperature 0.1) with the score gate; the
metric pose is a weighted Kabsch fit, one reweighting by the 3-D
residual, and a second fit; matches whose residual stays under 0.75 m are
the inliers, returned with ``R`` and ``t``.

``kabsch`` runs in float64 on every device: the JAX package runs it in
float32 under ``highest_precision``, and a float32 3 × 3 SVD on the card
is the kind of solve that lost a null vector in the RANSAC refit (ROADMAP
§C2). The singular vectors' signs are the library's choice; ``R`` and
``t`` do not depend on them where the singular values are distinct, so
only those are compared. Ties of ``argmax`` take the first index, as in
the JAX package.

No MicKey checkpoint (``mickey.ckpt``) is in the repository: the model
runs a user's ``checkpoint_npz`` or the port's seed-0 tree, which
``meta`` reports.
"""

import torch
import torch.nn.functional as F

from ...ops.matching import _softmax
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, full_fp32, init_bn,
                      init_conv, l2_normalize, max_pool, relu)

DESC_DIM = 128
CELL = 8
SIGMA = 0.25  # m, the reweighting's scale; inliers lie within 3·SIGMA


def _cbr(gen, cin, cout):
    return {"conv": init_conv(gen, 3, 3, cin, cout, bias=False),
            "bn": init_bn(cout)}


def init_params(gen):
    return {
        "trunk": [_cbr(gen, 3, 64), _cbr(gen, 64, 64), _cbr(gen, 64, 128),
                  _cbr(gen, 128, 128)],
        "offset": init_conv(gen, 1, 1, 128, 2),
        "depth": init_conv(gen, 1, 1, 128, 1),
        "score": init_conv(gen, 1, 1, 128, 1),
        "desc": init_conv(gen, 1, 1, 128, DESC_DIM),
    }


def heads(params, x):
    """x (B, 3, H, W) → per-cell keypoints (B, h, w, 2) px, depth (B, h,
    w) m, score (B, h, w) and unit descriptors (B, h, w, 128), h = H/8."""
    for i, p in enumerate(params["trunk"]):
        x = relu(batch_norm_inference(p["bn"], conv2d(p["conv"], x)))
        if i < 3:
            x = max_pool(x)
    off = torch.tanh(conv2d(params["offset"], x)) * (CELL / 2)
    depth = F.softplus(conv2d(params["depth"], x))[:, 0] + 0.1
    score = torch.sigmoid(conv2d(params["score"], x))[:, 0]
    desc = l2_normalize(conv2d(params["desc"], x), 1)
    _, hc, wc = score.shape
    gy, gx = torch.meshgrid(torch.arange(hc, device=x.device),
                            torch.arange(wc, device=x.device), indexing="ij")
    centers = torch.stack([gx, gy], -1).float() * CELL + CELL / 2
    return (centers + off.permute(0, 2, 3, 1), depth, score,
            desc.permute(0, 2, 3, 1))


def lift(kpts, depth, size):
    """Pinhole back-projection of (..., N, 2) keypoints at depth (..., N)
    with f = 0.7·max(w, h) and the centre as principal point; size (...,
    2) is (w, h)."""
    f = 0.7 * torch.maximum(size[..., 0], size[..., 1])[..., None]
    cx, cy = size[..., 0:1] / 2, size[..., 1:2] / 2
    x = (kpts[..., 0] - cx) / f * depth
    y = (kpts[..., 1] - cy) / f * depth
    return torch.stack([x, y, depth], -1)


def kabsch(p, q, w):
    """Weighted rigid alignment p → q in float64: p, q (B, N, 3), w (B,
    N). Returns R (B, 3, 3) and t (B, 3), float64."""
    p, q, w = p.double(), q.double(), w.double()
    wsum = w.sum(-1).clamp_min(1e-6)[:, None]
    mu_p = (p * w[..., None]).sum(1) / wsum
    mu_q = (q * w[..., None]).sum(1) / wsum
    cov = ((q - mu_q[:, None]) * w[..., None]).transpose(1, 2) @ (
        p - mu_p[:, None])
    u, _, vt = torch.linalg.svd(cov)
    d = torch.ones(len(p), 3, dtype=p.dtype, device=p.device)
    d[:, 2] = torch.sign(torch.linalg.det(u @ vt))
    r = u @ torch.diag_embed(d) @ vt
    t = mu_q - (r @ mu_p[..., None])[..., 0]
    return r, t


def match_pose(out0, out1, size0, size1, threshold):
    """The matches and metric pose of a batch of pairs from ``heads``'
    outputs; size* (B, 2) is (w, h)."""
    k0, d0, s0, f0 = out0
    k1, d1, s1, f1 = out1
    b = k0.shape[0]
    f0, f1 = f0.reshape(b, -1, DESC_DIM), f1.reshape(b, -1, DESC_DIM)
    sim = (f0 @ f1.transpose(1, 2)) / 0.1
    conf = _softmax(sim, 2) * _softmax(sim, 1)
    nn01 = conf.argmax(2)
    nn10 = conf.argmax(1)
    mutual = torch.arange(conf.shape[1], device=conf.device) == \
        nn10.gather(1, nn01)
    mscore = conf.amax(2) * s0.reshape(b, -1)
    ok = mutual & (mscore > threshold)

    def take(x):
        return x.gather(1, nn01[..., None].expand(-1, -1, x.shape[-1]))

    p0 = k0.reshape(b, -1, 2)
    p1 = take(k1.reshape(b, -1, 2))
    x0 = lift(p0, d0.reshape(b, -1), size0)
    x1 = take(lift(k1.reshape(b, -1, 2), d1.reshape(b, -1), size1))
    w = torch.where(ok, mscore, 0.0)
    r, t = kabsch(x0, x1, w)

    def residual(r, t):
        return torch.linalg.vector_norm(
            x0.double() @ r.transpose(1, 2) + t[:, None] - x1.double(),
            dim=-1)

    w2 = w * torch.exp(-(residual(r, t) / SIGMA) ** 2)
    r, t = kabsch(x0, x1, w2)
    inlier = ok & (residual(r, t) < 3 * SIGMA)
    return {"keypoints0": torch.where(inlier[..., None], p0, 0.0),
            "keypoints1": torch.where(inlier[..., None], p1, 0.0),
            "scores": torch.where(inlier, mscore, 0.0),
            "mask": inlier, "R": r.float(), "t": t.float()}


class Mickey(BaseModel):
    """Standalone matcher {image0, image1} → inlier correspondences and
    the metric relative pose ``R``, ``t``."""

    default_conf = {
        "config_path": "config.yaml",
        "model_name": "mickey.ckpt",
        "max_keypoints": 3000,
        "match_threshold": 0.0,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = weights.load_trained(
            conf, init_params(torch.Generator().manual_seed(0)), "mickey",
            self.device)

    def _forward(self, data):
        def prep(key):
            x = torch.as_tensor(data[key], dtype=torch.float32,
                                device=self.device)
            size = torch.tensor([[x.shape[3], x.shape[2]]],
                                dtype=torch.float32,
                                device=self.device).expand(len(x), 2)
            return (x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x), size

        (x0, size0), (x1, size1) = prep("image0"), prep("image1")
        with full_fp32():
            out = match_pose(heads(self.params, x0), heads(self.params, x1),
                             size0, size1,
                             float(self.conf.get("match_threshold", 0.0)))
        out["mconf"] = out["scores"]
        return out
