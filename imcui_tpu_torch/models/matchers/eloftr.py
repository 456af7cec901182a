"""EfficientLoFTR. Counterpart of ``imcui_tpu/models/matchers/eloftr.py``:
a backbone of re-parameterised RepVGG stages (one 3 × 3 conv with bias
and a ReLU a block; the first block of a stage has stride 2) and
*aggregated attention*: the coarse tokens are averaged over 2 × 2 cells,
attend at 1/16, and each message is broadcast back to its four cells. The
coarse assignment and the fine refinement are LoFTR's
(``models/matchers/loftr.py``), with 64-wide fine features. The registry
serves it at dfactor 32, so the 1/8 grid has even sides.

The upstream ``eloftr_outdoor.ckpt`` is not in the repository: the weights
are ``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says
which). float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import conv2d, init_conv, init_linear, relu
from . import loftr

D_COARSE = 256
D_FINE = 64


def init_repvgg_stage(gen, cin, cout, n_blocks):
    return [init_conv(gen, 3, 3, cin if i == 0 else cout, cout)
            for i in range(n_blocks)]


def repvgg_stage(blocks, x, stride):
    for i, p in enumerate(blocks):
        x = relu(conv2d(p, x, stride=stride if i == 0 else 1))
    return x


def init_params(gen, n_coarse_layers=4, n_fine_layers=2):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    return {
        "backbone": {
            "stage1": init_repvgg_stage(gen, 1, 64, 2),      # 1/2
            "stage2": init_repvgg_stage(gen, 64, 128, 2),    # 1/4
            "stage3": init_repvgg_stage(gen, 128, 256, 3),   # 1/8
            "fine_conv": init_conv(gen, 1, 1, 64, D_FINE),
        },
        "loftr_coarse": {"layers": [
            loftr.init_encoder_layer(gen, D_COARSE)
            for _ in range(n_coarse_layers)]},
        "loftr_fine": {"layers": [
            loftr.init_encoder_layer(gen, D_FINE)
            for _ in range(n_fine_layers)]},
        "fine_preprocess": {
            "down_proj": init_linear(gen, D_COARSE, D_FINE),
            "merge_feat": init_linear(gen, 2 * D_FINE, D_FINE),
        },
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "eloftr", device)


def backbone_apply(p, x):
    """x: (B, 1, H, W) → coarse (B, 256, H/8, W/8), fine (B, 64, H/2,
    W/2)."""
    x1 = repvgg_stage(p["stage1"], x, 2)
    x2 = repvgg_stage(p["stage2"], x1, 2)
    x3 = repvgg_stage(p["stage3"], x2, 2)
    return x3, conv2d(p["fine_conv"], x1)


def aggregated_attention(layer, x, source, grid_hw, src_hw, nhead=8):
    """Average the (h·w, d) tokens over 2 × 2 cells, run the encoder layer
    at 1/16, and add each pooled token's change back to its four cells."""
    (h, w), (hs, ws) = grid_hw, src_hw
    d = x.shape[-1]

    def pool(t, th, tw):
        return t.reshape(th // 2, 2, tw // 2, 2, d).mean((1, 3)).reshape(-1,
                                                                          d)

    xa = pool(x, h, w)
    out = loftr.encoder_layer(layer, xa, pool(source, hs, ws), nhead=nhead)
    delta = (out - xa).reshape(h // 2, w // 2, d)
    delta = delta.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return x + delta.reshape(-1, d)


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = backbone_apply(params["backbone"],
                                  torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    for i, layer in enumerate(params["loftr_coarse"]["layers"]):
        if i % 2 == 0:
            fc0 = aggregated_attention(layer, fc0, fc0, (hc, wc), (hc, wc))
            fc1 = aggregated_attention(layer, fc1, fc1, (hc, wc), (hc, wc))
        else:
            fc0n = aggregated_attention(layer, fc0, fc1, (hc, wc), (hc, wc))
            fc1 = aggregated_attention(layer, fc1, fc0, (hc, wc), (hc, wc))
            fc0 = fc0n
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, temperature=conf.get("temperature", 0.1),
        threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


class ELoFTR(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "weights": "weights/eloftr_outdoor.ckpt",
        "match_threshold": 0.2,
        "max_keypoints": 1024,
        "temperature": 0.1,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"eloftr weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "temperature": float(conf["temperature"]),
            "max_matches": int(conf.get("max_keypoints") or 1024)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
