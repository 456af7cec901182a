"""XoFTR, the cross-modal (visible ↔ thermal) LoFTR. Counterpart of
``imcui_tpu/models/matchers/xoftr.py``: LoFTR's backbone and coarse
transformer, with each view's coarse tokens whitened over its valid cells
first (mean 0, variance 1 per channel); the fine stage matches whole
windows against each other by a dual softmax inside the window pair, takes
the best token pair, and regresses a sub-pixel offset for both views with
a small MLP. A match is kept where its fine confidence is above 0.1; its
score is the coarse confidence times the fine one.

The upstream ``weights_xoftr_640.ckpt`` is not in the repository: the
weights are ``conf["checkpoint_npz"]`` or a seeded random tree (``meta``
says which). float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import gelu, init_linear, linear
from . import loftr


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    base = loftr.init_params(gen, n_coarse_layers=4, n_fine_layers=2)
    return {**base, "subpixel_mlp": {"0": init_linear(gen, 2 * 128, 128),
                                     "2": init_linear(gen, 128, 4)}}


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "xoftr", device)


def whiten(feat, mask):
    """(N, d) tokens → zero mean, unit variance per channel over the valid
    tokens (``mask`` (N,) bool)."""
    m = mask[:, None].to(feat.dtype)
    n = m.sum().clamp_min(1.0)
    mu = (feat * m).sum(0) / n
    var = ((feat - mu) ** 2 * m).sum(0) / n
    return (feat - mu) * torch.rsqrt(var + 1e-5)


def fine_window_match(params, win0, win1, valid, fine_thr=0.1):
    """win*: (M, W², d). The fine layers on each window pair, the dual
    softmax of their token correlation, its best token pair (the first on
    a tie) and the MLP's sub-pixel offsets. Returns offsets0, offsets1
    (M, 2) in fine pixels around the window centre, the fine confidence
    (M,) and keep (M,) = valid and confidence > fine_thr; offsets are 0
    where not kept."""
    w = loftr.FINE_WINDOW
    p0, p1 = win0, win1
    for i, layer in enumerate(params["loftr_fine"]["layers"]):
        if i % 2 == 0:
            p0 = loftr.encoder_layer(layer, p0, p0)
            p1 = loftr.encoder_layer(layer, p1, p1)
        else:
            p0n = loftr.encoder_layer(layer, p0, p1)
            p1 = loftr.encoder_layer(layer, p1, p0)
            p0 = p0n
    d = p0.shape[-1]
    sim = (p0 @ p1.transpose(1, 2)) / (d ** 0.5 * 0.1)
    conf = (torch.softmax(sim, 2) * torch.softmax(sim, 1)).flatten(1)
    fconf, best = conf.max(1)
    i0, i1 = best // (w * w), best % (w * w)
    rows = torch.arange(p0.shape[0], device=p0.device)
    ar = torch.arange(w, dtype=torch.float32, device=p0.device)
    grid = torch.stack([ar.repeat(w), ar.repeat_interleave(w)], -1)
    mlp = params["subpixel_mlp"]
    tok = torch.cat([p0[rows, i0], p1[rows, i1]], -1)
    sub = torch.tanh(linear(mlp["2"], gelu(linear(mlp["0"], tok))))
    keep = valid & (fconf > fine_thr)
    zero = torch.zeros((), device=p0.device)
    off0 = torch.where(keep[:, None], grid[i0] - w // 2 + sub[:, :2], zero)
    off1 = torch.where(keep[:, None], grid[i1] - w // 2 + sub[:, 2:], zero)
    return off0, off1, fconf, keep


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = loftr.backbone_apply(params["backbone"],
                                        torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    fc0, fc1 = loftr.coarse_transform(params["loftr_coarse"]["layers"],
                                      whiten(fc0, m0), whiten(fc1, m1), m0,
                                      m1)
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", 0.3),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    off0, off1, fconf, keep = fine_window_match(
        params, win0, win1, valid, fine_thr=conf.get("fine_threshold", 0.1))
    out = loftr.finish(idx0, idx1, score, keep, off1, wc, offsets0=off0)
    out["scores"] = torch.where(keep, score * fconf, torch.zeros_like(score))
    return out


class XoFTR(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs; ``max_keypoints`` -1 means 2048 slots."""

    default_conf = {
        "model_name": "weights_xoftr_640.ckpt",
        "match_threshold": 0.3,
        "max_keypoints": -1,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"xoftr weights: {self.meta}")
        mm = conf.get("max_keypoints")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "fine_threshold": 0.1,
            "max_matches": 2048 if mm in (-1, None) else int(mm)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
