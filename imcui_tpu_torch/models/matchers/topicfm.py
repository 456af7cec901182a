"""TopicFM, topic-modelled feature matching. Counterpart of
``imcui_tpu/models/matchers/topicfm.py``: LoFTR's backbone, fine stage and
dual-softmax assignment; in the coarse transformer the self layers are
LoFTR's linear attention and the cross layers a dense softmax attention
whose logits carry + log(pᵀq), the log of the two tokens' topic
co-assignment (each token's mixture over 100 learned topic embeddings).

The upstream ``model_best.ckpt`` is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
float32 throughout, as in the JAX package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import init_linear, layer_norm, linear, relu
from . import loftr

N_TOPICS = 100


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves
    (``topics`` is a (100, 256) table, not a linear weight)."""
    base = loftr.init_params(gen, n_coarse_layers=4, n_fine_layers=2)
    return {
        **base,
        "topics": torch.randn((N_TOPICS, loftr.D_COARSE), generator=gen)
        * 0.02,
        "topic_proj": init_linear(gen, loftr.D_COARSE, loftr.D_COARSE),
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "topicfm", device)


def topic_mixture(params, feat):
    """(L, d) → (L, T) topic distribution."""
    logits = linear(params["topic_proj"], feat) @ params["topics"].t()
    return torch.softmax(logits / loftr.D_COARSE ** 0.5, -1)


def topic_cross_attention(layer, x, source, tx, tsrc, mask_src, nhead=8):
    """Softmax cross attention of x (N, d) over source (M, d), logits +
    log(max(⟨topic_x, topic_src⟩, 1e-6)), keys masked by ``mask_src``,
    then LoFTR's merge, norms and MLP."""
    n, d = x.shape
    dh = d // nhead
    q = linear(layer["q_proj"], x).reshape(n, nhead, dh)
    k = linear(layer["k_proj"], source).reshape(-1, nhead, dh)
    v = linear(layer["v_proj"], source).reshape(-1, nhead, dh)
    logits = torch.einsum("nhd,mhd->hnm", q.float(), k.float()) / dh ** 0.5
    logits = logits + torch.log((tx @ tsrc.t()).clamp_min(1e-6))[None]
    logits = logits.masked_fill(~mask_src[None, None, :], -1e9)
    msg = torch.einsum("hnm,mhd->nhd", torch.softmax(logits, -1), v.float())
    msg = layer_norm(layer["norm1"], linear(layer["merge"], msg.reshape(
        n, d).to(x.dtype)))
    msg = torch.cat([x, msg], -1)
    msg = linear(layer["mlp"]["2"], relu(linear(layer["mlp"]["0"], msg)))
    return x + layer_norm(layer["norm2"], msg)


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = loftr.backbone_apply(params["backbone"],
                                        torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    for i, layer in enumerate(params["loftr_coarse"]["layers"]):
        if i % 2 == 0:
            fc0 = loftr.encoder_layer(layer, fc0, fc0, mask_src=m0)
            fc1 = loftr.encoder_layer(layer, fc1, fc1, mask_src=m1)
        else:
            t0 = topic_mixture(params, fc0)
            t1 = topic_mixture(params, fc1)
            fc0n = topic_cross_attention(layer, fc0, fc1, t0, t1, m1)
            fc1 = topic_cross_attention(layer, fc1, fc0, t1, t0, m0)
            fc0 = fc0n
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


class TopicFM(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs; ``max_keypoints`` -1 means 2048 slots."""

    default_conf = {
        "weights": "outdoor",
        "model_name": "model_best.ckpt",
        "match_threshold": 0.2,
        "n_sampling_topics": 4,
        "max_keypoints": -1,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"topicfm weights: {self.meta}")
        mm = conf.get("max_keypoints")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "max_matches": 2048 if mm in (-1, None) else int(mm)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
