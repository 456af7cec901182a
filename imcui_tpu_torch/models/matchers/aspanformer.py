"""ASpanFormer, adaptive-span attention. Counterpart of
``imcui_tpu/models/matchers/aspanformer.py``: LoFTR's backbone, fine stage
and dual-softmax assignment around a hierarchical coarse transformer. Two
linear-attention layers run on every fourth cell of every fourth row;
then, twice, each view's flow into the other is estimated (a soft-argmax
over the global correlation plus a learned correction), a fixed 5 × 5
span of the other view's tokens is gathered around it, and each token
attends densely to its span.

The upstream ``outdoor.ckpt`` is not in the repository: the weights are
``conf["checkpoint_npz"]`` or a seeded random tree (``meta`` says which).
The tree keeps the JAX package's unused ``loftr_coarse`` layers, so that
one tree serves both packages. float32 throughout, as in the JAX
package.
"""

import torch

from ... import logger
from ...utils import weights
from ...utils.base_model import BaseModel
from ..layers import init_linear, layer_norm, linear, relu
from . import loftr

SPAN = 5           # local attention window, in coarse cells
GLOBAL_STRIDE = 4  # the global pass runs on every 4th cell of every 4th row
N_ITERS = 2        # flow → span → attention iterations


def init_params(gen):
    """Random initialisation from ``gen`` with the JAX tree's leaves."""
    base = loftr.init_params(gen, n_coarse_layers=2, n_fine_layers=2)
    return {
        **base,
        "global_layers": [loftr.init_encoder_layer(gen, loftr.D_COARSE)
                          for _ in range(2)],
        "local_layers": [loftr.init_encoder_layer(gen, loftr.D_COARSE)
                         for _ in range(2 * N_ITERS)],
        "flow_head": init_linear(gen, loftr.D_COARSE, 2),
    }


def load_params(conf, device):
    init = init_params(torch.Generator().manual_seed(0))
    return weights.load_trained(conf, init, "aspanformer", device)


def _soft_flow(f0, f1, hc, wc, m1):
    """Soft-argmax over the correlation of f0 (L0, d) with f1's valid
    cells → (L0, 2) float (x, y) cell coordinates in f1's grid."""
    d = f0.shape[-1]
    sim = (f0.float() @ f1.float().t()) / (d ** 0.5 * 0.1)
    sim = sim.masked_fill(~m1[None, :], -1e9)
    attn = torch.softmax(sim, -1)
    cells = torch.arange(hc * wc, device=f0.device)
    grid = torch.stack([(cells % wc).float(), (cells // wc).float()], -1)
    return attn @ grid


def _gather_span(feat, mask, centers, hc, wc):
    """SPAN × SPAN windows of (hc·wc, d) tokens around rounded centres
    (half to even), moved inside the grid. Returns (L, SPAN², d) and
    (L, SPAN²) validity."""
    d = feat.shape[-1]
    r = SPAN // 2
    x0 = (torch.round(centers[:, 0]).long() - r).clamp(0, wc - SPAN)
    y0 = (torch.round(centers[:, 1]).long() - r).clamp(0, hc - SPAN)
    ar = torch.arange(SPAN, device=feat.device)
    flat = ((y0[:, None] + ar)[:, :, None] * wc
            + (x0[:, None] + ar)[:, None, :]).reshape(-1, SPAN * SPAN)
    return feat[flat], mask[flat]


def _local_cross(p, x, spans, span_mask, nhead=8):
    """Each token of x (L, d) attends by softmax to its span (L, S², d),
    keys masked by span_mask; then LoFTR's merge, norms and MLP."""
    n, d = x.shape
    dh = d // nhead
    q = linear(p["q_proj"], x).reshape(n, 1, nhead, dh)
    k = linear(p["k_proj"], spans).reshape(n, -1, nhead, dh)
    v = linear(p["v_proj"], spans).reshape(n, -1, nhead, dh)
    logits = torch.einsum("nqhd,nshd->nhqs", q.float(), k.float()) / dh ** 0.5
    logits = logits.masked_fill(~span_mask[:, None, None, :], -1e9)
    msg = torch.einsum("nhqs,nshd->nqhd", torch.softmax(logits, -1),
                       v.float())
    msg = layer_norm(p["norm1"], linear(p["merge"], msg.reshape(n, d).to(
        x.dtype)))
    msg = torch.cat([x, msg], -1)
    msg = linear(p["mlp"]["2"], relu(linear(p["mlp"]["0"], msg)))
    return x + layer_norm(p["norm2"], msg)


def coarse_transform(params, fc0, fc1, m0, m1, hc, wc):
    """The global pass on the strided sub-grid, then the flow-placed local
    spans."""
    idx = torch.arange(hc * wc, device=fc0.device).reshape(hc, wc)[
        ::GLOBAL_STRIDE, ::GLOBAL_STRIDE].reshape(-1)
    gm0, gm1 = m0[idx], m1[idx]
    for i, layer in enumerate(params["global_layers"]):
        g0, g1 = fc0[idx], fc1[idx]
        fc0, fc1 = fc0.clone(), fc1.clone()
        if i % 2 == 0:
            fc0[idx] = loftr.encoder_layer(layer, g0, g0, mask_src=gm0)
            fc1[idx] = loftr.encoder_layer(layer, g1, g1, mask_src=gm1)
        else:
            fc0[idx] = loftr.encoder_layer(layer, g0, g1, mask_src=gm1)
            fc1[idx] = loftr.encoder_layer(layer, g1, g0, mask_src=gm0)
    for it in range(N_ITERS):
        flow01 = _soft_flow(fc0, fc1, hc, wc, m1) + linear(
            params["flow_head"], fc0)
        flow10 = _soft_flow(fc1, fc0, hc, wc, m0) + linear(
            params["flow_head"], fc1)
        s1, sm1 = _gather_span(fc1, m1, flow01, hc, wc)
        s0, sm0 = _gather_span(fc0, m0, flow10, hc, wc)
        fc0 = _local_cross(params["local_layers"][2 * it], fc0, s1, sm1)
        fc1 = _local_cross(params["local_layers"][2 * it + 1], fc1, s0, sm0)
    return fc0, fc1


def forward_pair(params, image0, image1, wh0, wh1, conf):
    featc, featf = loftr.backbone_apply(params["backbone"],
                                        torch.stack([image0, image1]))
    hc, wc = featc.shape[2:]
    fc0, fc1 = loftr.coarse_tokens(featc)
    m0 = loftr.grid_mask(wh0, hc, wc, featc.device)
    m1 = loftr.grid_mask(wh1, hc, wc, featc.device)
    fc0, fc1 = coarse_transform(params, fc0, fc1, m0, m1, hc, wc)
    idx0, idx1, score, valid = loftr.coarse_match(
        fc0, fc1, m0, m1, threshold=conf.get("match_threshold", 0.2),
        max_matches=conf.get("max_matches", 1024))
    win0, win1 = loftr.fine_preprocess(params["fine_preprocess"], featf[0],
                                       featf[1], fc0, fc1, idx0, idx1, wc)
    offsets1 = loftr.fine_match(params, win0, win1, valid)
    return loftr.finish(idx0, idx1, score, valid, offsets1, wc)


class ASpanFormer(BaseModel):
    """Standalone dense matcher, the ``LoFTR`` wrapper's inputs and
    outputs."""

    default_conf = {
        "model_name": "outdoor.ckpt",
        "match_threshold": 0.2,
        "sinkhorn_iterations": 20,
        "max_keypoints": 2048,
    }
    required_inputs = ["image0", "image1"]

    def _init(self, conf):
        self.params, self.meta = load_params(conf, self.device)
        logger.info(f"aspanformer weights: {self.meta}")
        self.pair_conf = {
            "match_threshold": float(conf["match_threshold"]),
            "max_matches": int(conf.get("max_keypoints") or 2048)}

    @torch.inference_mode()
    def _forward(self, data):
        return loftr.forward_pairs(forward_pair, self.params, data,
                                   self.pair_conf, self.device)
