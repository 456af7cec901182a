"""MatchFormer, extract-and-match. Counterpart of
``imcui_tpu/models/matchers/matchformer.py``: a three-stage backbone
(strides 2, 2, 2; 64, 128, 256 channels) whose every block runs a self-
then a cross-attention between the two views, both as spatial-reduction
attention (keys and values average-pooled over r × r cells: r = 8, 4, 2),
so the features of each view are formed with the other in sight. The
coarse assignment and the fine refinement are LoFTR's; the fine windows
are cut from the first stage's map, at 1/2.

The upstream checkpoint is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import (batch_norm_inference, conv2d, init_bn, init_conv,
                      init_layer_norm, init_linear, layer_norm, linear, relu)
from . import loftr

D_COARSE = 256
D_FINE = 128
# (channels, blocks, sr_ratio) per stage; each stage has stride 2
STAGES = [(64, 1, 8), (128, 1, 4), (256, 2, 2)]
STAGE_STRIDE = 2


def init_attn_block(gen, d):
    return {
        "q": init_linear(gen, d, d),
        "kv": init_linear(gen, d, 2 * d),
        "proj": init_linear(gen, d, d),
        "ffn1": init_linear(gen, d, 4 * d),
        "ffn2": init_linear(gen, 4 * d, d),
        "ln1": init_layer_norm(d),
        "ln2": init_layer_norm(d),
    }


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    params = {"embeds": [], "stages": []}
    cin = 1
    for c, blocks, _ in STAGES:
        k = STAGE_STRIDE + 3
        params["embeds"].append({"conv": init_conv(gen, k, k, cin, c,
                                                   bias=False),
                                 "bn": init_bn(c)})
        params["stages"].append([{"self": init_attn_block(gen, c),
                                  "cross": init_attn_block(gen, c)}
                                 for _ in range(blocks)])
        cin = c
    params["coarse_proj"] = init_conv(gen, 1, 1, STAGES[-1][0], D_COARSE)
    params["fine_proj"] = init_conv(gen, 1, 1, STAGES[0][0], D_FINE)
    params["loftr_fine"] = {"layers": [loftr.init_encoder_layer(gen, D_FINE)
                                       for _ in range(2)]}
    params["fine_preprocess"] = {
        "down_proj": init_linear(gen, D_COARSE, D_FINE),
        "merge_feat": init_linear(gen, 2 * D_FINE, D_FINE),
    }
    return params


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "matchformer", device)


def _pool_tokens(x, h, w, r):
    """Spatial reduction: (h·w, d) tokens → the means of r × r cells,
    ((h//r)·(w//r), d); a remainder row or column is dropped."""
    if r == 1:
        return x
    d = x.shape[-1]
    t = x.reshape(h, w, d)[:h // r * r, :w // r * r]
    return (t.reshape(h // r, r, w // r, r, d).sum((1, 3)) / (r * r)
            ).reshape(-1, d)


def sra_attention(p, x, source, h, w, r, nhead=4):
    """x (N, d) attends by softmax to source's pooled tokens; post-norm
    residual attention and feed-forward."""
    n, d = x.shape
    dh = d // nhead
    q = linear(p["q"], x).reshape(n, nhead, dh)
    kv = linear(p["kv"], _pool_tokens(source, h, w, r)).reshape(
        -1, nhead, 2 * dh)
    k, v = kv[..., :dh], kv[..., dh:]
    logits = torch.einsum("nhd,mhd->hnm", q.float(), k.float()) / dh ** 0.5
    msg = torch.einsum("hnm,mhd->nhd", torch.softmax(logits, -1), v.float())
    x = layer_norm(p["ln1"], x + linear(p["proj"], msg.reshape(n, d).to(
        x.dtype)))
    x = x + linear(p["ffn2"], relu(linear(p["ffn1"], x)))
    return layer_norm(p["ln2"], x)


def backbone_interleaved(params, images):
    """images: (2, 1, H, W) → coarse (2, 256, H/8, W/8) and fine
    (2, 128, H/2, W/2) maps of both views."""
    f = images
    fine = None
    for si, (c, _, r) in enumerate(STAGES):
        e = params["embeds"][si]
        f = relu(batch_norm_inference(e["bn"], conv2d(e["conv"], f,
                                                      stride=STAGE_STRIDE)))
        h, w = f.shape[2:]
        t0, t1 = f.permute(0, 2, 3, 1).reshape(2, h * w, c)
        for blk in params["stages"][si]:
            t0 = sra_attention(blk["self"], t0, t0, h, w, r)
            t1 = sra_attention(blk["self"], t1, t1, h, w, r)
            t0n = sra_attention(blk["cross"], t0, t1, h, w, r)
            t1 = sra_attention(blk["cross"], t1, t0, h, w, r)
            t0 = t0n
        f = torch.stack([t0, t1]).reshape(2, h, w, c).permute(0, 3, 1, 2)
        if si == 0:
            fine = f
    return conv2d(params["coarse_proj"], f), conv2d(params["fine_proj"],
                                                    fine)


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = backbone_interleaved(params, torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


class MatchFormer(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "max_keypoints": 2048,
        "match_threshold": 0.2,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"matchformer weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "max_matches": int(conf.get("max_keypoints") or 2048)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
